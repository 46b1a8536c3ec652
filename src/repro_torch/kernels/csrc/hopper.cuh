// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels:
// mbarriers, TMA loads, wgmma shared-memory descriptors over swizzled bf16
// tiles cut into column panels, the wgmma instructions with f32
// accumulators, and the accumulator fragment's layout.  Used by flash_attention.cu and
// gla_scan.cu (namespace tc of each).  Everything is device code or
// constants: the header adds no symbol to a library's C interface.

#pragma once

#include <cuda.h>  // CUtensorMap
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {
namespace tc {

constexpr int kConsumers = 128;             // one warpgroup: the wgmma threads
constexpr int kBlock = kConsumers + 32;   // and one producer warp (TMA)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory layout of a bf16 tile [rows, W] as TMA writes it and wgmma
// reads it: the width is cut into column panels, W / 64 panels of 64
// columns (128-byte rows, 128-byte swizzle), then at most one of 32 columns
// (64-byte swizzle) and one of 16 (32-byte swizzle); e.g. 80 = 64 + 16,
// 48 = 32 + 16, 192 = 3 x 64.  The panels lie one after the other, widest
// first, each [rows, its width], so a panel holding columns from c0 on
// starts rows * 2 * c0 bytes into the tile; with rows a multiple of 8 every
// panel starts where its swizzle pattern does.  Each panel is its own TMA
// box, through a tensor map of its kind.
template <int W>
struct Panels {
  static_assert(W > 0 && W % 16 == 0, "widths are multiples of 16 columns");
  static constexpr int kN64 = W / 64;                     // 64-column panels
  static constexpr bool kHas32 = W % 64 >= 32;            // a 32-column panel
  static constexpr bool kHas16 = W % 32 == 16;            // a 16-column panel
  static constexpr int kC32 = 64 * kN64;                  // its first column
  static constexpr int kC16 = kC32 + (kHas32 ? 32 : 0);   // and this one's
  static constexpr int kKinds = (kN64 > 0) + kHas32 + kHas16;  // tensor maps
  static constexpr int kMap32 = kN64 > 0;  // index of the 32-column map
  static constexpr int kMap16 = kMap32 + kHas32;
  // first column and width of the panel holding column c
  __host__ __device__ static constexpr int first(int c) {
    return c < kC32 ? c / 64 * 64 : c < kC16 ? kC32 : kC16;
  }
  __host__ __device__ static constexpr int width(int c) {
    return c < kC32 ? 64 : c < kC16 ? 32 : 16;
  }
};

// One tensor map per panel kind of a width-W tensor (64, 32, 16 columns, in
// that order, those the width has)
template <int W>
struct TMaps {
  CUtensorMap m[Panels<W>::kKinds];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// wait for the phase of parity `parity` to complete; a barrier that has not
// completed after ~2^34 cycles (seconds) traps, so a fault in the protocol
// ends the launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// TMA: the box at (column c0, row c1, head c2) of a 3-D map [heads, rows, D]
// into shared memory; completion is counted on `bar` in bytes
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// rows [row, row + rows) of head `head`, every column: one box per panel
template <int W>
__device__ __forceinline__ void load_tile(uint8_t* dst, const TMaps<W>& maps,
                                          uint64_t* bar, int row, int head,
                                          int rows) {
  using P = Panels<W>;
#pragma unroll
  for (int h = 0; h < P::kN64; ++h)
    tma_load(dst + h * rows * 128, &maps.m[0], bar, h * 64, row, head);
  if constexpr (P::kHas32)
    tma_load(dst + rows * 2 * P::kC32, &maps.m[P::kMap32], bar, P::kC32, row,
             head);
  if constexpr (P::kHas16)
    tma_load(dst + rows * 2 * P::kC16, &maps.m[P::kMap16], bar, P::kC16, row,
             head);
}

// a wgmma shared-memory descriptor over a panel of PW columns (its rows
// PW * 2 bytes, swizzled over them: layout type 1 = 128 B, 2 = 64 B, 3 =
// 32 B)
template <int PW>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  static_assert(PW == 64 || PW == 32 || PW == 16, "panels are 64, 32 or 16 wide");
  constexpr uint64_t type = PW == 64 ? 1 : PW == 32 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (type << 62);
}

// descriptor of the k-th 16-column slice of a K-major tile [ROWS, W] (the
// reduction runs along W), taken from the panel that holds it: 8-row groups
// at 8 of the panel's rows; inside a swizzled row the slice starts 32 bytes
// further per step
template <int W, int ROWS>
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int k) {
  using P = Panels<W>;
  const int col = k * 16, c0 = P::first(col), pw = P::width(col);
  const uint32_t addr = base + ROWS * 2 * c0 + (col - c0) * 2;
  return pw == 64   ? make_desc<64>(addr, 16, 8 * 128)
         : pw == 32 ? make_desc<32>(addr, 16, 8 * 64)
                    : make_desc<16>(addr, 16, 8 * 32);
}

// descriptor of rows [16k, 16k + 16) of a run of panels of PW columns each
// read MN-major (the reduction runs along the rows, the panels' columns are
// the output width), the run starting at `base`: 8-row groups at 8 rows'
// bytes, the run's panels at ROWS rows' bytes
template <int PW, int ROWS>
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int k) {
  return make_desc<PW>(base + k * 16 * PW * 2, ROWS * PW * 2, 8 * PW * 2);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// the accumulator fragment of an m64nN product as the bf16 register A
// operand of the next product (16 columns per k step): the f32 layout of
// columns [16k, 16k + 16) is the operand layout, rounded to nearest even
template <int N>
__device__ __forceinline__ void to_operand(const float (&d)[N / 2],
                                           uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[k][j] = pack_bf16(d[8 * k + 2 * j], d[8 * k + 2 * j + 1]);
}

// The m64nNk16 bf16 products the kernels issue, f32 sums in registers:
// ss (both operands in shared memory) at N = 32 and 64, rs (A in
// registers) at N = 16, 32, 64, 128 and 192 (a run of panels).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d[64 x 16] = (acc ? d : 0) + A . B, A in registers (bf16 pairs), B in
  // shared memory, MN-major (transposed)
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{.reg .pred p; setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<32> {
  // d[64 x 32] = (acc ? d : 0) + A . B, A and B in shared memory, K-major
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{.reg .pred p; setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, "
        "%16, %17, p, 1, 1, 0, 0;}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
  // d[64 x 32] = (acc ? d : 0) + A . B, A in registers (bf16 pairs), B in
  // shared memory, MN-major (transposed)
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{.reg .pred p; setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  // d[64 x 64] = (acc ? d : 0) + A . B, A and B in shared memory, K-major
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{.reg .pred p; setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, "
        "%32, %33, p, 1, 1, 0, 0;}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  // d[64 x 64] = (acc ? d : 0) + A . B, A in registers (bf16 pairs), B in
  // shared memory, MN-major (transposed)
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{.reg .pred p; setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  // d[64 x 128] = (acc ? d : 0) + A . B, A in registers (bf16 pairs), B in
  // shared memory, MN-major (transposed)
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{.reg .pred p; setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<192> {
  // d[64 x 192] = (acc ? d : 0) + A . B, A in registers (bf16 pairs), B in
  // shared memory, MN-major (transposed)
  static __device__ __forceinline__ void rs(float (&d)[96],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{.reg .pred p; setp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, 1;}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};


// Where a thread's accumulator entries lie in an m64nN tile: warp w of the
// warpgroup holds rows 16w + lane/4 (+ 8 for the second pair of every four
// entries); entry i is column 8(i/4) + 2(lane%4) + i%2.
__device__ __forceinline__ int frag_row(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int frag_col(int i, int lane) {
  return (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
}

// columns [C0, C0 + N) of an m64nW accumulator fragment: entries
// [C0 / 2, C0 / 2 + N / 2), laid out as an m64nN fragment (C0 a multiple
// of 8)
template <int C0, int N, int M>
__device__ __forceinline__ float (&cols(float (&d)[M]))[N / 2] {
  static_assert(C0 % 8 == 0 && C0 / 2 + N / 2 <= M, "a run of whole 8-column groups");
  return *reinterpret_cast<float(*)[N / 2]>(d + C0 / 2);
}

// d[64 x W] += A . B[16k .. 16k + 16, W] with A in registers and B a tile
// [ROWS, W] at `base` read MN-major: one product for the run of 64-column
// panels, one for a 32-column panel and one for a 16-column panel, each
// into its own columns of the accumulator (one descriptor cannot span
// panels of two swizzles)
template <int W, int ROWS>
__device__ __forceinline__ void rs_panels(float (&d)[W / 2],
                                          const uint32_t (&a)[4],
                                          uint32_t base, int k) {
  using P = Panels<W>;
  if constexpr (P::kN64 > 0)
    Wgmma<64 * P::kN64>::rs(cols<0, 64 * P::kN64>(d), a,
                            mnmajor<64, ROWS>(base, k), 1);
  if constexpr (P::kHas32)
    Wgmma<32>::rs(cols<P::kC32, 32>(d), a,
                  mnmajor<32, ROWS>(base + ROWS * 2 * P::kC32, k), 1);
  if constexpr (P::kHas16)
    Wgmma<16>::rs(cols<P::kC16, 16>(d), a,
                  mnmajor<16, ROWS>(base + ROWS * 2 * P::kC16, k), 1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ void init_barriers(uint64_t* bars, int stages,
                                              int full_count) {
  // bars: full[stages], empty[stages], then one one-shot barrier
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&bars[s], full_count);
      mbar_init(&bars[stages + s], kConsumers);
    }
    mbar_init(&bars[2 * stages], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
}


// ------------------- pieces for kernels fed by cp.async -------------------

// byte offset of the 16-byte chunk `ch` (columns 8ch .. 8ch + 7) of row `r`
// in a bf16 panel [rows, 64] laid out as Panels<64> says (128-byte rows,
// swizzled over 8-row groups; the panel starts on a 1024-byte boundary):
// the layout TMA's 128-byte swizzle writes and kmajor / mnmajor describe
__device__ __forceinline__ uint32_t sw128(int r, int ch) {
  return static_cast<uint32_t>(r * 128 + (((ch ^ r) & 7) << 4));
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// `valid` is false (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}
// make this thread's ordinary writes to shared memory (stores, cp.async)
// visible to wgmma, which reads through the async proxy; a barrier follows
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// an f32 value as a bf16 pair, hi = bf16(x) and lo = bf16(x - hi): the two
// products hi . y + lo . y with a bf16 y keep ~16 bits of x's mantissa
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// to_operand for an f32 accumulator fed to the next product as a hi/lo pair
template <int N>
__device__ __forceinline__ void to_operand_split(const float (&d)[N / 2],
                                                 uint32_t (&hi)[N / 16][4],
                                                 uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split_bf16(d[8 * k + 2 * j], d[8 * k + 2 * j + 1], &hi[k][j], &lo[k][j]);
}

// d[64 x 64] = (acc ? d : 0) + A . B, A and B in shared memory, each
// read K-major (TA / TB = 0) or MN-major (1: the operand is stored
// transposed, contiguous along M / N; bf16 only)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int acc) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, %35, %36;}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// d[64 x 128] = (acc ? d : 0) + A . B, A and B in shared memory, each
// read K-major (TA / TB = 0) or MN-major (1: the operand is stored
// transposed, contiguous along M / N; bf16 only)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int acc) {
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, %67, %68;}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

}  // namespace tc
}  // namespace
