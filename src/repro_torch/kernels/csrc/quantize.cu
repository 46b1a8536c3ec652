// Blockwise and per-(page, head) int8 quantize / dequantize for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/quantize.py
// (quantize_blockwise, body _quant_kernel; dequantize_blockwise, body
// _dequant_kernel; quantize_page, body _quant_page_kernel; dequantize_page,
// body _dequant_page_kernel).  The blockwise pair computes, for x [R, N]
// with N % block == 0:
//
//   amax  = max |x| over each run of `block` elements of a row   (f32)
//   scale = amax / 127, or 1 where amax is 0                      (f32)
//   q     = clip(rint(x / scale), -127, 127)                      (int8)
//   x'    = q * scale                                             (f32/bf16)
//
// and the page pair the same over each (page, head) of KV pages
// x [n_pages, ps, H, d] (one scale per page and head, [n_pages, H]),
// bit-exact with the reference: the quotients are IEEE divisions
// (__fdiv_rn, never a multiply by the reciprocal) and the rounding is
// round-half-to-even (rintf, never roundf).
//
// What bounds them on this card: bytes.  Quantize reads 4 (f32) or 2 (bf16)
// bytes and writes 1 byte plus 4/block bytes per element, with a handful
// of operations each; dequantize reads 1 + 4/block and writes 4.
//
// Blockwise design.  The TPU kernel tiles rows x lane-tiles so the max-abs
// reduction stays inside one VMEM tile.  Here one warp owns one
// quantization block: its lanes read the block with unit stride
// (coalesced), reduce the max-abs with a butterfly of shuffles (max is
// exact in any order), and quantize the same elements again, which are
// still in L1/L2.  Eight warps share a thread block.  Dequantize is a
// grid-stride elementwise pass.  They move their bytes at 90% (quantize)
// and 58% (dequantize) of the card's rate, so they are left as they are.
//
// Page design.  The first page kernels (one warp per (page, head), one
// 4-byte load per lane, every element read twice, a 64-bit i / d and
// i % d per element; dequantize two 64-bit divisions per element) moved
// their bytes at 40% and 36% of the rate: instructions per byte, not
// bytes, bounded them.  Now:
//  - quantize_page: a block of 256 threads takes `ppb` whole pages, one
//    (page, head) a warp where pages allow (and at least 16 KB of input).
//    It copies them to shared memory once with 16-byte cp.async (`V`
//    elements a unit: 4 f32 or 8 bf16), then each warp takes a (page,
//    head): its max-abs over the head's ps rows from shared memory by
//    shuffles, the scale, then its int8 from the same copy, stored 4 or 8
//    bytes a lane (when the block holds fewer heads than warps, R warps
//    share a head's rows and meet in shared memory).  Row and column come
//    from loop counters, a head's page and head from one 32-bit division.
//    A page too large for shared memory (`kStaged` false) is read twice
//    from device memory by the same warps.
//  - dequantize_page: a block takes `ppb` pages (16 KB of int8), puts
//    their scales in shared memory, and walks them in units of `U` int8,
//    4 for f32 and 8 for bf16 out, so that each lane writes one 16-byte
//    store and a warp 512 contiguous bytes (16 int8 a lane, as four
//    16-byte stores 64 bytes apart, took twice the time); a unit's head
//    and page come from counters carried across a stride of 256 units
//    (mixed-radix adds, no division in the loop).
//  - `V` and `U` fall to 1 (one element a unit) where d is not a multiple
//    of the vector or a pointer is not aligned to it: the same kernels.
// The host side (`page_plan` in quantize.py) picks V/U, ppb and kStaged
// and the launchers check them.  What bounds them now (PERF.md): f32 at
// ~80% of the bytes' time; bf16 quantize at ~64%, where the per-element
// IEEE division is the likely limit (not measured).
// Built without fast math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale, int64_t n_blocks, int block) {
  const int64_t qb = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (qb >= n_blocks) return;
  const T* xb = x + qb * block;
  int8_t* out = q + qb * block;
  float amax = 0.f;
  for (int i = lane; i < block; i += 32) amax = fmaxf(amax, fabsf(to_f32(xb[i])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = amax > 0.f ? __fdiv_rn(amax, 127.0f) : 1.0f;
  for (int i = lane; i < block; i += 32) {
    const float r = rintf(__fdiv_rn(to_f32(xb[i]), s));
    out[i] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
  }
  if (lane == 0) scale[qb] = s;
}

template <typename O>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                  O* __restrict__ out, int64_t n, int block) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride)
    out[i] = from_f32<O>(__fmul_rn(static_cast<float>(q[i]), scale[i / block]));
}

// ---- per-(page, head) kernels of x [n_pages, ps, H, d] ----

// the largest range of pages a quantize block stages in shared memory
// (quantize.py's PAGE_MAX_STAGE); larger pages are read twice instead
constexpr int kMaxStage = 200 * 1024;

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// V consecutive elements at p (aligned to V elements) as f32
template <typename T, int V>
__device__ __forceinline__ void load_unit(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f32(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V == 4, "f32 units are one float4");
    const float4 w = *reinterpret_cast<const float4*>(p);
    f[0] = w.x; f[1] = w.y; f[2] = w.z; f[3] = w.w;
  } else {
    static_assert(V == 8, "bf16 units are 16 bytes");
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // bf16 -> f32 is exact: the high half
      f[2 * k] = __uint_as_float(u[k] << 16);
      f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  }
}

// U int8 at p (aligned to U bytes) as f32
template <int U>
__device__ __forceinline__ void load_i8(const int8_t* p, float (&f)[U]) {
  if constexpr (U == 1) {
    f[0] = static_cast<float>(p[0]);
  } else {
    static_assert(U == 4 || U == 8, "int8 units are 4 or 8 bytes");
    unsigned u[U / 4];
    if constexpr (U == 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      u[0] = w.x; u[1] = w.y;
    } else {
      u[0] = *reinterpret_cast<const unsigned*>(p);
    }
#pragma unroll
    for (int k = 0; k < U; ++k)
      f[k] = static_cast<float>(static_cast<int8_t>(u[k / 4] >> (8 * (k % 4))));
  }
}

// U values to p: one 16-byte store (4 f32 or 8 bf16, p aligned to 16
// bytes), or one value
template <typename O, int U>
__device__ __forceinline__ void store_unit(O* p, const float (&f)[U]) {
  if constexpr (U == 1) {
    p[0] = from_f32<O>(f[0]);
  } else {
    static_assert(U * sizeof(O) == 16, "one 16-byte store");
    unsigned u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (sizeof(O) == 4) {
        u[k] = __float_as_uint(f[k]);
      } else {
        const unsigned lo = __bfloat16_as_ushort(from_f32<O>(f[2 * k]));
        const unsigned hi = __bfloat16_as_ushort(from_f32<O>(f[2 * k + 1]));
        u[k] = lo | (hi << 16);
      }
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

__device__ __forceinline__ int8_t quantize_one(float x, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f));
}

// How a warp's lanes cover the units of a task's rows: a row is nv units;
// rows shorter than a warp are taken rpw at a time (lanes past rpw * nv
// idle), longer ones 32 units at a time.
struct Lanes {
  int rr, c0, cstep, rpw;
  __device__ Lanes(int nv, int lane)
      : rr(nv >= 32 ? 0 : lane / nv), c0(nv >= 32 ? lane : lane % nv),
        cstep(nv >= 32 ? 32 : nv), rpw(nv >= 32 ? 1 : 32 / nv) {}
};

// Copy `units` units of V elements from `src` to shared memory `dst`: 16
// bytes a cp.async (the caller waits), one element by plain loads and
// stores.
template <typename T, int V>
__device__ __forceinline__ void stage_units(T* dst, const T* src, int units) {
  for (int u = threadIdx.x; u < units; u += kThreads) {
    if constexpr (V * sizeof(T) == 16) {
      const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + u * V));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(s), "l"(src + u * V));
    } else {
      dst[u] = src[u];
    }
  }
}

// Quantize np pages whose elements start at `in` (shared or device memory)
// into q and their scales into scale, both already offset to the first
// page.  A task is (page pb, head h, row share j of R): rows j, j + R, ...
// of that head; R = 1 once the pages hold 8 heads or more.
template <typename T, int V>
__device__ __forceinline__ void quantize_pages(const T* in, int8_t* q,
                                               float* scale, int np, int ps,
                                               int H, int d, float* part) {
  const int nv = d / V;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Lanes L(nv, lane);
  const int heads = np * H;
  const int R = heads >= kWarps ? 1 : kWarps / heads;

  auto task_max = [&](int pb, int h, int j) {
    float m = 0.f;
    if (L.rr < L.rpw)
      for (int r = j + R * L.rr; r < ps; r += R * L.rpw) {
        const T* row = in + (static_cast<int64_t>(pb * ps + r) * H + h) * d;
        for (int c = L.c0; c < nv; c += L.cstep) {
          float f[V];
          load_unit<T, V>(row + c * V, f);
#pragma unroll
          for (int e = 0; e < V; ++e) m = fmaxf(m, fabsf(f[e]));
        }
      }
    return warp_max(m);
  };
  auto task_quantize = [&](int pb, int h, int j, float s) {
    if (L.rr >= L.rpw) return;
    for (int r = j + R * L.rr; r < ps; r += R * L.rpw) {
      const int64_t off = (static_cast<int64_t>(pb * ps + r) * H + h) * d;
      for (int c = L.c0; c < nv; c += L.cstep) {
        float f[V];
        load_unit<T, V>(in + off + c * V, f);
        int8_t* dst = q + off + c * V;
        if constexpr (V == 1) {
          dst[0] = quantize_one(f[0], s);
        } else {
          unsigned u[V / 4];
#pragma unroll
          for (int k = 0; k < V / 4; ++k) {
            u[k] = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              u[k] |= static_cast<unsigned>(static_cast<uint8_t>(
                          quantize_one(f[4 * k + e], s))) << (8 * e);
          }
          if constexpr (V == 4) *reinterpret_cast<unsigned*>(dst) = u[0];
          else *reinterpret_cast<uint2*>(dst) = make_uint2(u[0], u[1]);
        }
      }
    }
  };
  auto scale_of = [](float amax) {
    return amax > 0.f ? __fdiv_rn(amax, 127.0f) : 1.0f;
  };

  if (R == 1) {  // a warp owns whole (page, head)s: max, scale, quantize
    for (int ph = warp; ph < heads; ph += kWarps) {
      const int pb = ph / H, h = ph - pb * H;
      const float s = scale_of(task_max(pb, h, 0));
      if (lane == 0) scale[ph] = s;
      task_quantize(pb, h, 0, s);
    }
  } else {  // fewer heads than warps: R warps a head, met in shared memory
    const int ph = warp / R, j = warp - ph * R;
    const bool on = ph < heads;
    const float m = on ? task_max(ph / H, ph % H, j) : 0.f;
    if (lane == 0) part[warp] = m;
    __syncthreads();
    if (on) {
      float amax = 0.f;
      for (int i = 0; i < R; ++i) amax = fmaxf(amax, part[ph * R + i]);
      const float s = scale_of(amax);
      if (j == 0 && lane == 0) scale[ph] = s;
      task_quantize(ph / H, ph % H, j, s);
    }
  }
}

// One block: ppb pages from page0 (the last block may hold fewer), staged
// in shared memory first where kStaged.
template <typename T, int V, bool kStaged>
__global__ void __launch_bounds__(kThreads)
quantize_page_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int64_t n_pages, int ps, int H,
                     int d, int ppb) {
  extern __shared__ __align__(16) unsigned char stage_raw[];
  __shared__ float part[kWarps];
  const int64_t page0 = static_cast<int64_t>(blockIdx.x) * ppb;
  const int np = n_pages - page0 < ppb ? static_cast<int>(n_pages - page0) : ppb;
  const int64_t e0 = page0 * ps * H * d;  // the block's first element
  const T* in = x + e0;
  if constexpr (kStaged) {
    T* stage = reinterpret_cast<T*>(stage_raw);
    stage_units<T, V>(stage, in, np * ps * H * (d / V));
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    in = stage;
  }
  quantize_pages<T, V>(in, q + e0, scale + page0 * H, np, ps, H, d, part);
}

// One block: ppb pages from page0, walked in units of U int8.  A thread's
// unit u = threadIdx.x + k * kThreads is carried as digits (page pb, row r,
// head h, unit in row c) of radices (., ps, H, nv), advanced by the digits
// of kThreads: adds and one carry each, no division in the loop.
template <typename O, int U>
__global__ void __launch_bounds__(kThreads)
dequantize_page_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ scale, O* __restrict__ out,
                       int64_t n_pages, int ps, int H, int d, int ppb) {
  extern __shared__ float sc[];  // the block's np x H scales
  const int64_t page0 = static_cast<int64_t>(blockIdx.x) * ppb;
  const int np = n_pages - page0 < ppb ? static_cast<int>(n_pages - page0) : ppb;
  for (int i = threadIdx.x; i < np * H; i += kThreads) sc[i] = scale[page0 * H + i];
  __syncthreads();
  const int nv = d / U;
  const int64_t e0 = page0 * ps * H * d;
  const int64_t units = static_cast<int64_t>(np) * ps * H * nv;
  int c = threadIdx.x % nv, seg = threadIdx.x / nv;
  int h = seg % H, rows = seg / H;
  int r = rows % ps, pb = rows / ps;
  const int dc = kThreads % nv, dseg = kThreads / nv;
  const int dh = dseg % H, drows = dseg / H;
  const int dr = drows % ps, dpb = drows / ps;
  for (int64_t u = threadIdx.x; u < units; u += kThreads) {
    const float s = sc[pb * H + h];
    float f[U];
    load_i8<U>(q + e0 + u * U, f);
#pragma unroll
    for (int e = 0; e < U; ++e) f[e] = __fmul_rn(f[e], s);
    store_unit<O, U>(out + e0 + u * U, f);
    c += dc;
    if (c >= nv) { c -= nv; ++h; }
    h += dh;
    if (h >= H) { h -= H; ++r; }
    r += dr;
    if (r >= ps) { r -= ps; ++pb; }
    pb += dpb;
  }
}

template <typename T, int V, bool kStaged>
int launch_quantize_page(const void* x, int8_t* q, float* scale,
                         int64_t n_pages, int ps, int H, int d, int ppb,
                         int64_t grid, cudaStream_t s) {
  const size_t smem = kStaged ? static_cast<size_t>(ppb) * ps * H * d * sizeof(T) : 0;
  auto kernel = quantize_page_kernel<T, V, kStaged>;
  if (smem > 46 * 1024) {  // 48 KB less static shared memory without opting in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      static_cast<const T*>(x), q, scale, n_pages, ps, H, d, ppb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_quantize_page(const void* x, int8_t* q, float* scale,
                         int64_t n_pages, int ps, int H, int d, int vec,
                         int ppb, int staged, int64_t grid, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    return staged ? launch_quantize_page<T, kVec, true>(x, q, scale, n_pages, ps, H, d, ppb, grid, s)
                  : launch_quantize_page<T, kVec, false>(x, q, scale, n_pages, ps, H, d, ppb, grid, s);
  return staged ? launch_quantize_page<T, 1, true>(x, q, scale, n_pages, ps, H, d, ppb, grid, s)
                : launch_quantize_page<T, 1, false>(x, q, scale, n_pages, ps, H, d, ppb, grid, s);
}

template <typename O, int U>
int launch_dequantize_page(const int8_t* q, const float* scale, void* out,
                           int64_t n_pages, int ps, int H, int d, int ppb,
                           int64_t grid, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(ppb) * H * sizeof(float);
  auto kernel = dequantize_page_kernel<O, U>;
  if (smem > 46 * 1024) {  // 48 KB less static shared memory without opting in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      q, scale, static_cast<O*>(out), n_pages, ps, H, d, ppb);
  return static_cast<int>(cudaGetLastError());
}

template <typename O>
int launch_dequantize_page(const int8_t* q, const float* scale, void* out,
                           int64_t n_pages, int ps, int H, int d, int unit,
                           int ppb, int64_t grid, cudaStream_t s) {
  constexpr int kUnit = 16 / sizeof(O);
  if (unit == kUnit)
    return launch_dequantize_page<O, kUnit>(q, scale, out, n_pages, ps, H, d, ppb, grid, s);
  return launch_dequantize_page<O, 1>(q, scale, out, n_pages, ps, H, d, ppb, grid, s);
}

}  // namespace

// in_dtype: 0 = f32, 1 = bf16.  x is contiguous [rows, n], n % block == 0;
// q is int8 [rows, n], scale f32 [rows, n / block].  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int quantize_blockwise_launch(const void* x, int8_t* q,
                                         float* scale, int64_t rows,
                                         int64_t n, int block, int in_dtype,
                                         void* stream) {
  if (block < 1 || n % block) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_blocks = rows * (n / block);
  if (n_blocks == 0) return 0;
  const int64_t grid = (n_blocks + kWarps - 1) / kWarps;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    quantize_kernel<float><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        static_cast<const float*>(x), q, scale, n_blocks, block);
  else if (in_dtype == 1)
    quantize_kernel<__nv_bfloat16><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), q, scale, n_blocks, block);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// out_dtype: 0 = f32, 1 = bf16.  out is contiguous [rows, n].
extern "C" int dequantize_blockwise_launch(const int8_t* q, const float* scale,
                                           void* out, int64_t rows, int64_t n,
                                           int block, int out_dtype,
                                           void* stream) {
  if (block < 1 || n % block) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = rows * n;
  if (total == 0) return 0;
  int64_t grid = (total + kThreads - 1) / kThreads;
  if (grid > 132 * 64) grid = 132 * 64;  // grid-stride beyond a few waves
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    dequantize_kernel<float><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        q, scale, static_cast<float*>(out), total, block);
  else if (out_dtype == 1)
    dequantize_kernel<__nv_bfloat16><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        q, scale, static_cast<__nv_bfloat16*>(out), total, block);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// in_dtype: 0 = f32, 1 = bf16.  x and q are contiguous [n_pages, ps, H, d],
// scale f32 [n_pages, H].  vec (elements a unit: 16 bytes' worth, or 1),
// ppb (pages a block) and staged come from quantize.py's page_plan and
// are checked here: d % vec == 0, x and q aligned to a unit, a staged
// range of at most kMaxStage bytes.
extern "C" int quantize_page_launch(const void* x, int8_t* q, float* scale,
                                    int64_t n_pages, int ps, int H, int d,
                                    int in_dtype, int vec, int ppb, int staged,
                                    void* stream) {
  if (ps < 1 || H < 1 || d < 1 || ppb < 1 || (in_dtype != 0 && in_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = in_dtype == 0 ? 4 : 2;
  if ((vec != 1 && vec != 16 / elem) || d % vec ||
      reinterpret_cast<uintptr_t>(x) % (vec * elem) ||
      reinterpret_cast<uintptr_t>(q) % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  if (staged && static_cast<int64_t>(ppb) * ps * H * d * elem > kMaxStage)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pages == 0) return 0;
  const int64_t grid = (n_pages + ppb - 1) / ppb;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    return launch_quantize_page<float>(x, q, scale, n_pages, ps, H, d, vec, ppb, staged, grid, s);
  return launch_quantize_page<__nv_bfloat16>(x, q, scale, n_pages, ps, H, d, vec, ppb, staged, grid, s);
}

// out_dtype: 0 = f32, 1 = bf16.  out is contiguous [n_pages, ps, H, d].
// unit (int8 a load: 16 bytes of output, 4 for f32 and 8 for bf16, or 1)
// and ppb come from page_plan: d % unit == 0, q aligned to a unit and out
// to 16 bytes where unit > 1.
extern "C" int dequantize_page_launch(const int8_t* q, const float* scale,
                                      void* out, int64_t n_pages, int ps,
                                      int H, int d, int out_dtype, int unit,
                                      int ppb, void* stream) {
  if (ps < 1 || H < 1 || d < 1 || ppb < 1 || (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((unit != 1 && unit != (out_dtype == 0 ? 4 : 8)) || d % unit ||
      reinterpret_cast<uintptr_t>(q) % unit ||
      (unit > 1 && reinterpret_cast<uintptr_t>(out) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pages == 0) return 0;
  const int64_t grid = (n_pages + ppb - 1) / ppb;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return launch_dequantize_page<float>(q, scale, out, n_pages, ps, H, d, unit, ppb, grid, s);
  return launch_dequantize_page<__nv_bfloat16>(q, scale, out, n_pages, ps, H, d, unit, ppb, grid, s);
}
