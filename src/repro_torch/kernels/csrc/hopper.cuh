// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels:
// mbarriers, TMA loads, wgmma shared-memory descriptors over 128-byte
// swizzled bf16 tiles, the wgmma instructions with f32 accumulators, and
// the accumulator fragment's layout.  Used by flash_attention.cu and
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

// Shared-memory layout of a bf16 tile [rows, D] as TMA writes it and wgmma
// reads it: rows of min(D, 64) columns, swizzled over their width (32 B at
// D = 16, 64 B at D = 32, 128 B at D >= 64); D = 128 is two such column
// halves, one after the other.
template <int D>
struct Layout {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kHalves = D / kCols;
  // wgmma descriptor layout type: 1 = 128 B, 2 = 64 B, 3 = 32 B swizzle
  static constexpr uint64_t kType = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
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

// rows [row, row + rows) of head `head`, every column (two boxes at D = 128)
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row, int head,
                                          int rows) {
  using L = Layout<D>;
#pragma unroll
  for (int h = 0; h < L::kHalves; ++h)
    tma_load(dst + h * rows * L::kRowBytes, map, bar, h * L::kCols, row, head);
}

template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (Layout<D>::kType << 62);
}

// descriptor of the k-th 16-column slice of a K-major tile [ROWS, D] (the
// reduction runs along D): 8-row groups at 8 rows' bytes; inside a swizzled
// row the slice starts 32 bytes further per step
template <int D, int ROWS>
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int k) {
  using L = Layout<D>;
  const int col = k * 16;
  const uint32_t off = (col / L::kCols) * ROWS * L::kRowBytes + (col % L::kCols) * 2;
  return make_desc<D>(base + off, 16, 8 * L::kRowBytes);
}

// descriptor of rows [16k, 16k + 16) of the same tile read MN-major (the
// reduction runs along the rows, D is the output width): 8-row groups at
// 8 rows' bytes, column halves at ROWS rows' bytes
template <int D, int ROWS>
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int k) {
  using L = Layout<D>;
  return make_desc<D>(base + k * 16 * L::kRowBytes, ROWS * L::kRowBytes,
                      8 * L::kRowBytes);
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
// registers) at N = d.
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

// Where a thread's accumulator entries lie in an m64nN tile: warp w of the
// warpgroup holds rows 16w + lane/4 (+ 8 for the second pair of every four
// entries); entry i is column 8(i/4) + 2(lane%4) + i%2.
__device__ __forceinline__ int frag_row(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int frag_col(int i, int lane) {
  return (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
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
// in a bf16 panel [rows, 64] laid out as Layout<64> (128-byte rows,
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
