// Paged decode attention for Hopper (sm_90a), one query row per sequence,
// read in place off a paged K/V pool through a page table.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention, body _paged_kernel).  It computes the same function:
//
//   s_j   = dot(k_j, q) * (k_scale * sm_scale)      slot j of a page
//   masked slots (slot >= length) score -1e30 and get probability +0.0
//   m'    = max(m, max_j s_j);  alpha = exp(m - m');  p_j = exp(s_j - m')
//   l     = l * alpha + sum_j p_j
//   acc   = acc * alpha + (sum_j p_j v_j) * v_scale
//   out   = acc / max(l, 1e-30)                      (length 0 -> exact 0)
//
// What bounds it on this card: the bytes of K/V pages it reads.  Per
// (row, head) it touches 2 * length * d elements and does ~4 flops per
// element, far below the ~20 flops/byte the f32 units need to be the limit,
// so the kernel is memory-bound at every tier.
//
// Design.  The TPU kernel walks a (row, head, page) grid in order and keeps
// the online-softmax state in VMEM across grid steps; blocks here run in
// parallel and in no order, so:
//   * one thread block per (q-head, row) owns the whole recurrence for its
//     pair and loops over pages itself; nothing is carried between blocks;
//   * the block reads its own table row and length and loops only over the
//     row's own pages, ceil(length / ps).  A fully masked page leaves
//     (m, l, acc) bit-for-bit unchanged in the reference recurrence
//     (alpha = exp(0) = 1, p = +0.0), so skipping pages past the length is
//     exact, and extra pad columns of the table are never read;
//   * page ids are table[b, p] + page_offset[h] and the in-page head is
//     kv_head[h], so one call serves all ranks' head shards of a stacked
//     pool, as the TPU kernel's index maps do;
//   * four warps split the slots of a page; a warp reduces its dot product
//     over d in a fixed order (each lane sums a strided set sequentially,
//     then a butterfly of shuffles), so a (row, head)'s bits depend on
//     nothing but its own inputs: not on grouping, batch, npm or the pool
//     position of its pages;
//   * every thread of the block repeats the scalar recurrence over the
//     page's scores in the same order, and owns the output lanes
//     t, t + 128, ... of the accumulator;
//   * pages are stored as f32, bf16, int8 or e4m3 and converted to f32 in
//     registers; int8/e4m3 pages carry per-(page, kv-head) scales.
// It uses no tensor cores, TMA or wgmma: a simple kernel that is right.
// Built without fast math: expf is the accurate one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 4;  // dv <= kThreads * kMaxPerThread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f32(const int8_t* p) {
  return static_cast<float>(*p);
}
__device__ __forceinline__ float load_f32(const __nv_fp8_e4m3* p) {
  return static_cast<float>(*p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,        // [B, Hq, d]
                       const T* __restrict__ k_pages,      // [n_pages, ps, Hkv, d]
                       const T* __restrict__ v_pages,      // [n_pages, ps, Hkv, dv]
                       const int* __restrict__ table,      // [B, npm]
                       const int* __restrict__ lengths,    // [B]
                       const float* __restrict__ k_scale,  // [n_pages, Hkv]
                       const float* __restrict__ v_scale,  // [n_pages, Hkv]
                       const int* __restrict__ kv_head,    // [Hq]
                       const int* __restrict__ page_offset,  // [Hq]
                       float* __restrict__ out,            // [B, Hq, dv]
                       int Hq, int d, int dv, int ps, int Hkv, int npm,
                       float sm_scale) {
  extern __shared__ float smem[];
  float* q_s = smem;       // [d]
  float* s_s = smem + d;   // [ps]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* qrow = q + (static_cast<int64_t>(b) * Hq + h) * d;
  for (int i = tid; i < d; i += kThreads) q_s[i] = qrow[i];

  const int length = lengths[b];
  const int hk = kv_head[h];
  const int poff = page_offset[h];
  int n_pages_row = length > 0 ? (length + ps - 1) / ps : 0;
  if (n_pages_row > npm) n_pages_row = npm;

  float m = kNegInf;
  float l = 0.f;
  float acc[kMaxPerThread];
#pragma unroll
  for (int r = 0; r < kMaxPerThread; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int p = 0; p < n_pages_row; ++p) {
    const int64_t page = static_cast<int64_t>(table[b * npm + p]) + poff;
    const float ks = k_scale[page * Hkv + hk];
    const float vs = v_scale[page * Hkv + hk];
    const float factor = ks * sm_scale;

    // scores of this page's slots: warp w takes slots w, w + 4, ...
    for (int j = warp; j < ps; j += kWarps) {
      const T* krow = k_pages + ((page * ps + j) * Hkv + hk) * d;
      float part = 0.f;
      for (int i = lane; i < d; i += 32) part += load_f32(krow + i) * q_s[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) {
        const bool visible = p * ps + j < length;
        s_s[j] = visible ? part * factor : kNegInf;
      }
    }
    __syncthreads();

    // the scalar recurrence, repeated identically by every thread
    float m_new = m;
    for (int j = 0; j < ps; ++j) m_new = fmaxf(m_new, s_s[j]);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    float pv[kMaxPerThread];
#pragma unroll
    for (int r = 0; r < kMaxPerThread; ++r) pv[r] = 0.f;
    for (int j = 0; j < ps; ++j) {
      const bool visible = p * ps + j < length;
      const float pj = visible ? expf(s_s[j] - m_new) : 0.f;
      psum += pj;
      const T* vrow = v_pages + ((page * ps + j) * Hkv + hk) * dv;
#pragma unroll
      for (int r = 0; r < kMaxPerThread; ++r) {
        const int i = tid + r * kThreads;
        if (i < dv) pv[r] += pj * load_f32(vrow + i);
      }
    }
    l = l * alpha + psum;
#pragma unroll
    for (int r = 0; r < kMaxPerThread; ++r) acc[r] = acc[r] * alpha + pv[r] * vs;
    m = m_new;
    __syncthreads();  // s_s is rewritten by the next page
  }

  const float denom = fmaxf(l, 1e-30f);
  float* orow = out + (static_cast<int64_t>(b) * Hq + h) * dv;
#pragma unroll
  for (int r = 0; r < kMaxPerThread; ++r) {
    const int i = tid + r * kThreads;
    if (i < dv) orow[i] = acc[r] / denom;
  }
}

template <typename T>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const int* table, const int* lengths, const float* ks,
                   const float* vs, const int* kv_head, const int* page_offset,
                   float* out, int B, int Hq, int d, int dv, int ps, int Hkv,
                   int npm, float sm_scale, cudaStream_t stream) {
  if (B == 0 || Hq == 0) return cudaSuccess;
  const dim3 grid(Hq, B);
  const size_t smem = static_cast<size_t>(d + ps) * sizeof(float);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), table, lengths,
      ks, vs, kv_head, page_offset, out, Hq, d, dv, ps, Hkv, npm, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Storage codes: 0 = f32, 1 = bf16, 2 = int8, 3 = e4m3.  Returns the
// cudaError_t of the launch (0 on success); shapes are checked by the caller.
extern "C" int paged_attention_launch(
    const float* q, const void* k_pages, const void* v_pages, const int* table,
    const int* lengths, const float* k_scale, const float* v_scale,
    const int* kv_head, const int* page_offset, float* out, int B, int Hq,
    int d, int dv, int ps, int Hkv, int npm, float sm_scale, int storage,
    void* stream) {
  if (d < 1 || dv < 1 || dv > kThreads * kMaxPerThread || ps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0:
      return launch<float>(q, k_pages, v_pages, table, lengths, k_scale,
                           v_scale, kv_head, page_offset, out, B, Hq, d, dv,
                           ps, Hkv, npm, sm_scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k_pages, v_pages, table, lengths,
                                   k_scale, v_scale, kv_head, page_offset, out,
                                   B, Hq, d, dv, ps, Hkv, npm, sm_scale, s);
    case 2:
      return launch<int8_t>(q, k_pages, v_pages, table, lengths, k_scale,
                            v_scale, kv_head, page_offset, out, B, Hq, d, dv,
                            ps, Hkv, npm, sm_scale, s);
    case 3:
      return launch<__nv_fp8_e4m3>(q, k_pages, v_pages, table, lengths,
                                   k_scale, v_scale, kv_head, page_offset, out,
                                   B, Hq, d, dv, ps, Hkv, npm, sm_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
