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
// Design.  The TPU kernel tiles rows x lane-tiles so the max-abs reduction
// stays inside one VMEM tile.  Here one warp owns one quantization block:
// its lanes read the block with unit stride (coalesced), reduce the
// max-abs with a butterfly of shuffles (max is exact in any order), and
// quantize the same elements again, which are still in L1/L2.  Eight warps
// share a thread block.  Dequantize is a grid-stride elementwise pass.  The
// page kernels are the same with one warp per (page, head): its ps rows of
// d elements lie H*d apart, each row read with unit stride.
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

// one warp per (page, head) of x [n_pages, ps, H, d]
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_page_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int64_t n_ph, int ps, int H,
                     int d) {
  const int64_t ph = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (ph >= n_ph) return;
  const int64_t page = ph / H, h = ph % H;
  const int64_t base = (page * ps * H + h) * d;  // row r at base + r * H * d
  const int n = ps * d;
  float amax = 0.f;
  for (int i = lane; i < n; i += 32)
    amax = fmaxf(amax, fabsf(to_f32(x[base + static_cast<int64_t>(i / d) * H * d + i % d])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = amax > 0.f ? __fdiv_rn(amax, 127.0f) : 1.0f;
  for (int i = lane; i < n; i += 32) {
    const int64_t off = base + static_cast<int64_t>(i / d) * H * d + i % d;
    const float r = rintf(__fdiv_rn(to_f32(x[off]), s));
    q[off] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
  }
  if (lane == 0) scale[ph] = s;
}

template <typename O>
__global__ void __launch_bounds__(kThreads)
dequantize_page_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ scale, O* __restrict__ out,
                       int64_t n, int ps, int H, int d) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t hd = static_cast<int64_t>(H) * d, page_elems = hd * ps;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const int64_t sidx = (i / page_elems) * H + (i % hd) / d;
    out[i] = from_f32<O>(__fmul_rn(static_cast<float>(q[i]), scale[sidx]));
  }
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
// scale f32 [n_pages, H].
extern "C" int quantize_page_launch(const void* x, int8_t* q, float* scale,
                                    int64_t n_pages, int ps, int H, int d,
                                    int in_dtype, void* stream) {
  if (ps < 1 || H < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_ph = n_pages * H;
  if (n_ph == 0) return 0;
  const int64_t grid = (n_ph + kWarps - 1) / kWarps;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    quantize_page_kernel<float><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        static_cast<const float*>(x), q, scale, n_ph, ps, H, d);
  else if (in_dtype == 1)
    quantize_page_kernel<__nv_bfloat16><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), q, scale, n_ph, ps, H, d);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// out_dtype: 0 = f32, 1 = bf16.  out is contiguous [n_pages, ps, H, d].
extern "C" int dequantize_page_launch(const int8_t* q, const float* scale,
                                      void* out, int64_t n_pages, int ps,
                                      int H, int d, int out_dtype,
                                      void* stream) {
  if (ps < 1 || H < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = n_pages * ps * H * d;
  if (total == 0) return 0;
  int64_t grid = (total + kThreads - 1) / kThreads;
  if (grid > 132 * 64) grid = 132 * 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    dequantize_page_kernel<float><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        q, scale, static_cast<float*>(out), total, ps, H, d);
  else if (out_dtype == 1)
    dequantize_page_kernel<__nv_bfloat16><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        q, scale, static_cast<__nv_bfloat16*>(out), total, ps, H, d);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
