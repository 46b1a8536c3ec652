// GQA flash attention for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel).  The forward computes the same
// function:
//
//   s_ij  = (q_i . k_j) * sm_scale                       f32
//   mask  = k_j < S  [and k_j <= q_i (causal)]  [and k_j > q_i - window]
//           with q positions shifted by q_offset; masked scores are -1e30
//           and get probability +0.0
//   online softmax over kv tiles: m' = max(m, max_j s_ij); alpha = exp(m - m')
//   l = l * alpha + sum_j p_ij;  acc = acc * alpha + sum_j p_ij v_j
//   out_i = acc / max(l, 1e-30)  (a row that sees no key is exact 0)
//   lse_i = m + log(l)           (f32, kept for the backward; 0 for an
//                                 empty row, whose p is masked to 0 anyway)
//
// The reference has no backward kernel (it differentiates its XLA twin);
// the backward here is the gradient of the same function, recomputing p
// from q, k and lse:
//
//   D_i   = sum_c dout_ic * out_ic            (preprocess kernel)
//   p_ij  = exp(s_ij - lse_i)  (masked -> 0)
//   dv_j  = sum_i p_ij dout_i
//   ds_ij = p_ij (dout_i . v_j - D_i)
//   dk_j  = sm_scale * sum_i ds_ij q_i
//   dq_i  = sm_scale * sum_j ds_ij k_j
//
// What bounds it on this card: operations.  At the training shape (B 2,
// Hq 32, T = S = 2048, d 64, causal) the forward does ~34 GFLOP on ~40 MB,
// far above the ~295 flop/byte where the bf16 tensor cores stop being the
// limit.  Two routes, chosen by dtype alone:
//
// * bf16 (namespace tc): the tensor cores.  Every block is one consumer
//   warpgroup (128 threads, 64 rows of wgmma) and one producer warp.  The
//   producer's TMA loads fill a 2-stage ring of tiles in shared memory, an
//   mbarrier pair per stage marking it full and empty, while the warpgroup
//   runs wgmma.mma_async on the tiles that have arrived.  Tensors are seen
//   by 3-D tensor maps [B*H, T|S, d], so a ragged tail zero-fills inside
//   its own head.  Rows are swizzled over min(d, 64) columns (32 B at d 16,
//   64 B at d 32, 128 B at d >= 64; d 128 is two 64-column halves), and
//   the wgmma descriptors read the same layout K-major or, for the
//   operand reduced along its rows (V, dO, Q, K), MN-major.
//     - forward: one block per (b*hq, 64 q rows); Q loaded once, K and V
//       tiles of 64 keys.  S = Q K^T with both operands in shared memory;
//       the online softmax stays in registers, a row's max and sum meeting
//       across the 4 threads that share it through shuffles in a fixed
//       order; P goes to bf16 in registers and is the register A operand
//       of O += P V.  One warpgroup of 64 rows (not two): 2048 blocks at
//       the training shape keep every SM busy, and at ~100 registers a
//       thread three blocks share an SM, so one block's softmax overlaps
//       another's products.
//     - backward, deterministic (no atomics; the same inputs give the
//       same bits): the delta kernel; a dK/dV kernel, one block per
//       (b*hkv, 64 keys), K and V resident, walking the group's q heads
//       and each head's visible q tiles (64 rows, 32 at d 128) in order:
//       S^T = K Q^T, P^T, dV += P^T dO, dP^T = V dO^T, dS^T, dK += dS^T Q;
//       and a dQ kernel, one block per (b*hq, 64 q rows), Q and dO
//       resident, walking its visible kv tiles of 64 keys in order: S, P,
//       dP = dO V^T, dS, dQ += dS K.  That is 7 products where the bound
//       counts 5: S and dP are computed twice, the price of a dQ without
//       atomics (the alternative, FA3's dQ reduced through ordered
//       semaphores, costs a dq accumulator in device memory and a
//       serialised reduction; recomputing is simpler and exactly
//       repeatable).
//     - the mask is applied element by element only on tiles that
//       straddle the causal diagonal, the window's edge, the tail past S
//       (and, in the dK/dV kernel, the tail past T); tiles that no row can
//       see are skipped (Mask::kv_tiles, Mask::q_rows), which is exact.
//     - numerics: q, k, v, dout are bf16 products summed in f32 by the
//       tensor cores; scores, m, l, lse, D and every accumulator are f32.
//       P is rounded to bf16 before P V (as the plain version does,
//       p.to(q.dtype)); dS is rounded to bf16 before dK and dQ.  Scores
//       are kept in log2 units (sm_scale * log2(e) multiplies the f32
//       scores, exp2f takes the place of expf, lse is stored in natural
//       units).  No fast math: exp2f and logf are the accurate ones.
// * f32: the SIMT kernels below (TF32 on the tensor cores could not meet
//   f32's tolerance).  The forward gives each q row TPR adjacent threads
//   (TPR = d / 64 for d = 128, else 1) holding q and acc in registers,
//   with K and V tiles of 32 keys staged in shared memory; the backward
//   has one launch per (b*hkv, kv-block), each thread owning one key and
//   accumulating dk and dv over the group's q tiles in a fixed order, and
//   one per (b*hq, q-block), each thread owning one q row.  Every score,
//   probability and accumulator is f32.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// The mask and the skip ranges derived from it.  Host code runs the same
// functions in flash_attention_tile_plan, which chip_smoke.py holds against
// the element mask.
struct Mask {
  int S, causal, window, q_offset;
  __host__ __device__ __forceinline__ bool visible(int qpos, int kpos) const {
    bool ok = kpos < S;
    if (causal) ok = ok && kpos <= qpos;
    if (window) ok = ok && kpos > qpos - window;
    return ok;
  }
  // [lo, hi) tiles of `tile` keys holding a key visible to some q position
  // in [q_first, q_last]
  __host__ __device__ __forceinline__ void kv_tiles(int q_first, int q_last,
                                                    int tile, int* lo,
                                                    int* hi) const {
    int k_max = S - 1;
    if (causal && q_last < k_max) k_max = q_last;
    int k_min = 0;
    if (window && q_first - window + 1 > 0) k_min = q_first - window + 1;
    if (k_max < k_min) {
      *lo = 0;
      *hi = 0;
      return;
    }
    *lo = k_min / tile;
    *hi = k_max / tile + 1;
  }
  // [lo, hi) q rows (of T) that see some key in [k_first, k_last]
  __host__ __device__ __forceinline__ void q_rows(int k_first, int k_last,
                                                  int T, int* lo,
                                                  int* hi) const {
    int a = causal && k_first - q_offset > 0 ? k_first - q_offset : 0;
    int b = T;
    if (window && k_last + window - q_offset < T) b = k_last + window - q_offset;
    *lo = a;
    *hi = b > a ? b : a;
  }
  // [lo, hi) tiles of `bq` q rows (of T) holding a row that sees some key
  // in [k_first, k_last]
  __host__ __device__ __forceinline__ void q_tiles(int k_first, int k_last,
                                                   int T, int bq, int* lo,
                                                   int* hi) const {
    int a, b;
    q_rows(k_first, k_last, T, &a, &b);
    *lo = a / bq;
    *hi = b > a ? (b + bq - 1) / bq : *lo;
  }
  // A (q, k) tile that every valid q row sees whole: no element mask needed
  __host__ __device__ __forceinline__ bool tile_full(int q_first, int q_last,
                                                     int k_first,
                                                     int k_last) const {
    bool full = k_last < S;
    if (causal) full = full && k_last <= q_first;
    if (window) full = full && k_first > q_last - window;
    return full;
  }
};

// sum over the TPR adjacent lanes of a row; every lane gets the same bits
template <int TPR>
__device__ __forceinline__ float row_sum(float a) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

template <int N>
__device__ __forceinline__ float dot_smem(const float* x, const float* s) {
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(s + i);
    a += x[i] * t.x;
    a += x[i + 1] * t.y;
    a += x[i + 2] * t.z;
    a += x[i + 3] * t.w;
  }
  return a;
}

// stage rows [r0, r0 + rows) of a [n, D] matrix into f32 shared memory,
// zero past n, optionally scaled
template <typename T, int D>
__device__ __forceinline__ void stage(float (*dst)[D], const T* src, int r0,
                                      int rows, int n, float scale) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int j = e / D, c = e - j * D;
    const int r = r0 + j;
    dst[j][c] = r < n ? to_f32(src[static_cast<int64_t>(r) * D + c]) * scale
                      : 0.f;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q,   // [B, Hq, T, D]
                 const T* __restrict__ k,   // [B, Hkv, S, D]
                 const T* __restrict__ v,   // [B, Hkv, S, D]
                 T* __restrict__ out,       // [B, Hq, T, D]
                 float* __restrict__ lse,   // [B, Hq, T]
                 int Hq, int Hkv, int Tq, Mask mask, float sm_scale) {
  constexpr int DT = D < 64 ? D : 64;  // dims of a row each thread holds
  constexpr int TPR = D / DT;          // threads per q row
  constexpr int BQ = kThreads / TPR;   // q rows per block
  __shared__ __align__(16) float k_s[kTile][D];
  __shared__ __align__(16) float v_s[kTile][D];

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int d0 = (tid % TPR) * DT;
  const int row = blockIdx.x * BQ + tid / TPR;
  const bool row_ok = row < Tq;
  const int qpos = mask.q_offset + row;

  float qr[DT], acc[DT];
  const T* qrow = q + (static_cast<int64_t>(bh) * Tq + (row_ok ? row : 0)) * D + d0;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    qr[i] = row_ok ? to_f32(qrow[i]) * sm_scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const int q_first = mask.q_offset + blockIdx.x * BQ;
  const int q_last = mask.q_offset + min(Tq, (blockIdx.x + 1) * BQ) - 1;
  int lo, hi;
  mask.kv_tiles(q_first, q_last, kTile, &lo, &hi);
  const T* kb = k + static_cast<int64_t>(bkv) * mask.S * D;
  const T* vb = v + static_cast<int64_t>(bkv) * mask.S * D;

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile is consumed
    stage<T, D>(k_s, kb, k0, kTile, mask.S, 1.f);
    stage<T, D>(v_s, vb, k0, kTile, mask.S, 1.f);
    __syncthreads();

    float s[kTile];
    unsigned vis = 0u;
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float a = row_sum<TPR>(dot_smem<DT>(qr, &k_s[j][d0]));
      const bool ok = mask.visible(qpos, k0 + j);
      vis |= ok ? (1u << j) : 0u;
      s[j] = ok ? a : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < DT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = (vis >> j) & 1u ? expf(s[j] - m_new) : 0.f;
      psum += p;
      const float* vr = &v_s[j][d0];
#pragma unroll
      for (int i = 0; i < DT; i += 4) {
        const float4 w = *reinterpret_cast<const float4*>(vr + i);
        acc[i] += p * w.x;
        acc[i + 1] += p * w.y;
        acc[i + 2] += p * w.z;
        acc[i + 3] += p * w.w;
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = out + (static_cast<int64_t>(bh) * Tq + row) * D + d0;
#pragma unroll
    for (int i = 0; i < DT; ++i) orow[i] = from_f32<T>(acc[i] / denom);
    if (d0 == 0)
      lse[static_cast<int64_t>(bh) * Tq + row] = l > 0.f ? m + logf(l) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// D_i = sum_c dout_ic * out_ic, one warp per row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                    threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* o = out + r * D;
  const T* g = dout + r * D;
  float a = 0.f;
  for (int c = lane; c < D; c += 32) a += to_f32(o[c]) * to_f32(g[c]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) a += __shfl_xor_sync(0xffffffffu, a, w);
  if (lane == 0) delta[r] = a;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Hq, int Hkv, int Tq, Mask mask,
                      float sm_scale) {
  constexpr int DT = D < 32 ? D : 32;
  constexpr int TPR = D / DT;
  constexpr int BKV = kThreads / TPR;  // keys per block
  constexpr int BQ = 32;               // q rows per shared-memory tile
  __shared__ __align__(16) float q_s[BQ][D];
  __shared__ __align__(16) float g_s[BQ][D];
  __shared__ float lse_s[BQ];
  __shared__ float del_s[BQ];

  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, hk = bkv - b * Hkv;
  const int group = Hq / Hkv;
  const int tid = threadIdx.x;
  const int d0 = (tid % TPR) * DT;
  const int key = blockIdx.x * BKV + tid / TPR;
  const bool key_ok = key < mask.S;

  float kr[DT], vr[DT], dkr[DT], dvr[DT];
  const int64_t koff =
      (static_cast<int64_t>(bkv) * mask.S + (key_ok ? key : 0)) * D + d0;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    kr[i] = key_ok ? to_f32(k[koff + i]) : 0.f;
    vr[i] = key_ok ? to_f32(v[koff + i]) : 0.f;
    dkr[i] = 0.f;
    dvr[i] = 0.f;
  }
  const int k_first = blockIdx.x * BKV;
  const int k_last = min(mask.S, k_first + BKV) - 1;
  int i_lo, i_hi;
  mask.q_rows(k_first, k_last, Tq, &i_lo, &i_hi);

  for (int g = 0; g < group; ++g) {
    const int64_t bh = static_cast<int64_t>(b) * Hq + hk * group + g;
    const T* qh = q + bh * Tq * D;
    const T* gh = dout + bh * Tq * D;
    for (int t0 = i_lo; t0 < i_hi; t0 += BQ) {
      const int rows = min(BQ, i_hi - t0);
      __syncthreads();
      stage<T, D>(q_s, qh, t0, BQ, Tq, sm_scale);
      stage<T, D>(g_s, gh, t0, BQ, Tq, 1.f);
      if (tid < BQ) {
        const bool ok = t0 + tid < Tq;
        lse_s[tid] = ok ? lse[bh * Tq + t0 + tid] : 0.f;
        del_s[tid] = ok ? delta[bh * Tq + t0 + tid] : 0.f;
      }
      __syncthreads();
      for (int r = 0; r < rows; ++r) {  // uniform over the block
        const float s = row_sum<TPR>(dot_smem<DT>(kr, &q_s[r][d0]));
        const float dp = row_sum<TPR>(dot_smem<DT>(vr, &g_s[r][d0]));
        const bool ok = key_ok && mask.visible(mask.q_offset + t0 + r, key);
        const float p = ok ? expf(s - lse_s[r]) : 0.f;
        const float ds = p * (dp - del_s[r]);
        const float* qs = &q_s[r][d0];
        const float* gs = &g_s[r][d0];
#pragma unroll
        for (int i = 0; i < DT; i += 4) {
          const float4 a = *reinterpret_cast<const float4*>(gs + i);
          const float4 c = *reinterpret_cast<const float4*>(qs + i);
          dvr[i] += p * a.x;
          dvr[i + 1] += p * a.y;
          dvr[i + 2] += p * a.z;
          dvr[i + 3] += p * a.w;
          dkr[i] += ds * c.x;
          dkr[i + 1] += ds * c.y;
          dkr[i + 2] += ds * c.z;
          dkr[i + 3] += ds * c.w;
        }
      }
    }
  }
  if (key_ok) {
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      dk[koff + i] = from_f32<T>(dkr[i]);
      dv[koff + i] = from_f32<T>(dvr[i]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Hq, int Hkv, int Tq, Mask mask, float sm_scale) {
  constexpr int DT = D < 32 ? D : 32;
  constexpr int TPR = D / DT;
  constexpr int BQ = kThreads / TPR;
  __shared__ __align__(16) float k_s[kTile][D];
  __shared__ __align__(16) float v_s[kTile][D];

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int d0 = (tid % TPR) * DT;
  const int row = blockIdx.x * BQ + tid / TPR;
  const bool row_ok = row < Tq;
  const int qpos = mask.q_offset + row;

  const int64_t roff = (static_cast<int64_t>(bh) * Tq + (row_ok ? row : 0)) * D + d0;
  float qr[DT], gr[DT], dqr[DT];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    qr[i] = row_ok ? to_f32(q[roff + i]) * sm_scale : 0.f;
    gr[i] = row_ok ? to_f32(dout[roff + i]) : 0.f;
    dqr[i] = 0.f;
  }
  const int64_t ridx = static_cast<int64_t>(bh) * Tq + (row_ok ? row : 0);
  const float lse_r = row_ok ? lse[ridx] : 0.f;
  const float del_r = row_ok ? delta[ridx] : 0.f;

  const int q_first = mask.q_offset + blockIdx.x * BQ;
  const int q_last = mask.q_offset + min(Tq, (blockIdx.x + 1) * BQ) - 1;
  int lo, hi;
  mask.kv_tiles(q_first, q_last, kTile, &lo, &hi);
  const T* kb = k + static_cast<int64_t>(bkv) * mask.S * D;
  const T* vb = v + static_cast<int64_t>(bkv) * mask.S * D;

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    stage<T, D>(k_s, kb, k0, kTile, mask.S, 1.f);
    stage<T, D>(v_s, vb, k0, kTile, mask.S, 1.f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float s = row_sum<TPR>(dot_smem<DT>(qr, &k_s[j][d0]));
      const float dp = row_sum<TPR>(dot_smem<DT>(gr, &v_s[j][d0]));
      const bool ok = row_ok && mask.visible(qpos, k0 + j);
      const float p = ok ? expf(s - lse_r) : 0.f;
      const float ds = p * (dp - del_r);
      const float* kr = &k_s[j][d0];
#pragma unroll
      for (int i = 0; i < DT; i += 4) {
        const float4 w = *reinterpret_cast<const float4*>(kr + i);
        dqr[i] += ds * w.x;
        dqr[i + 1] += ds * w.y;
        dqr[i + 2] += ds * w.z;
        dqr[i + 3] += ds * w.w;
      }
    }
  }
  if (row_ok) {
#pragma unroll
    for (int i = 0; i < DT; ++i) dq[roff + i] = from_f32<T>(dqr[i] * sm_scale);
  }
}

inline int cdiv(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Hq, int Hkv, int Tq, const Mask& mask,
                float sm_scale, cudaStream_t stream) {
  constexpr int TPR = D < 64 ? 1 : D / 64;
  const dim3 grid(cdiv(Tq, kThreads / TPR), B * Hq);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Hq, Hkv, Tq, mask,
      sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int B, int Hq, int Hkv, int Tq,
                const Mask& mask, float sm_scale, cudaStream_t stream) {
  constexpr int TPR = D < 32 ? 1 : D / 32;
  const int64_t rows = static_cast<int64_t>(B) * Hq * Tq;
  flash_bwd_delta_kernel<T, D><<<cdiv(rows, kThreads / 32), kThreads, 0,
                                 stream>>>(static_cast<const T*>(out),
                                           static_cast<const T*>(dout), delta,
                                           rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (mask.S > 0) {
    const dim3 gkv(cdiv(mask.S, kThreads / TPR), B * Hkv);
    flash_bwd_dkdv_kernel<T, D><<<gkv, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv, Tq, mask, sm_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 gq(cdiv(Tq, kThreads / TPR), B * Hq);
  flash_bwd_dq_kernel<T, D><<<gq, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Hq, Hkv, Tq, mask, sm_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma on bf16 tiles fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

// ------------------------------- forward ----------------------------------

template <int D>
struct Fwd {
  static constexpr int BM = 64;                 // q rows per block
  // keys per kv tile: at 64 a thread holds 32 scores, the kernel ~100
  // registers, and three blocks share an SM; at 128, two
  static constexpr int BK = 64;
  static constexpr int STAGES = 2;  // depth of the TMA ring
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (2 * STAGES + 1);
};

template <int D>
__global__ void __launch_bounds__(kBlock)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int Hq, int Hkv, int Tq, Mask mask, float sm_scale) {
  using C = Fwd<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* kv_s = q_s + C::Q_BYTES;  // stage s: K at 2s, V at 2s + 1
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(kv_s + C::STAGES * 2 * C::KV_BYTES);
  uint64_t* full = bars;
  uint64_t* empty = bars + C::STAGES;
  uint64_t* q_bar = bars + 2 * C::STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int q0 = qt * C::BM;
  const int q_first = mask.q_offset + q0;
  const int q_last = mask.q_offset + min(Tq, q0 + C::BM) - 1;
  int lo, hi;
  mask.kv_tiles(q_first, q_last, C::BK, &lo, &hi);
  init_barriers(bars, C::STAGES, 1);

  if (threadIdx.x >= kConsumers) {  // the producer warp: one lane issues TMA
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_bar, C::Q_BYTES);
      load_tile<D>(q_s, &tm_q, q_bar, q0, bh, C::BM);
      for (int t = lo; t < hi; ++t) {
        const int it = t - lo, s = it % C::STAGES;
        if (it >= C::STAGES) mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
        uint8_t* k_s = kv_s + 2 * s * C::KV_BYTES;
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        load_tile<D>(k_s, &tm_k, &full[s], t * C::BK, bkv, C::BK);
        load_tile<D>(k_s + C::KV_BYTES, &tm_v, &full[s], t * C::BK, bkv, C::BK);
      }
    }
    return;
  }

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);  // rows r0, r0 + 8
  const float sl2 = sm_scale * kLog2e;  // scores in log2 units: exp2f
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(q_s);
  mbar_wait(q_bar, 0);

  for (int t = lo; t < hi; ++t) {
    const int it = t - lo, s = it % C::STAGES;
    const uint32_t k_addr = smem_u32(kv_s + 2 * s * C::KV_BYTES);
    const uint32_t v_addr = k_addr + C::KV_BYTES;
    mbar_wait(&full[s], (it / C::STAGES) & 1);

    float x[C::BK / 2];  // S = Q . K^T, f32
    wg_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      Wgmma<C::BK>::ss(x, kmajor<D, C::BM>(q_addr, k),
                       kmajor<D, C::BK>(k_addr, k), k > 0);
    wg_commit();
    wg_wait();
    fence_regs(x);

    const int k0 = t * C::BK;
    const bool edge = !mask.tile_full(q_first, q_last, k0, k0 + C::BK - 1);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < C::BK / 2; ++i) {
      float v = x[i] * sl2;
      if (edge && !mask.visible(mask.q_offset + q0 + r0 + 8 * frag_row(i),
                                k0 + frag_col(i, lane)))
        v = -INFINITY;  // exp2f gives +0.0; m stays finite
      x[i] = v;
      mx[frag_row(i)] = fmaxf(mx[frag_row(i)], v);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < C::BK / 2; ++i) {
      x[i] = exp2f(x[i] - m[frag_row(i)]);  // p, f32
      l[frag_row(i)] += x[i];
    }
    uint32_t p[C::BK / 16][4];  // p rounded to bf16: the A operand of P . V
    to_operand<C::BK>(x, p);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[frag_row(i)];
    wg_fence();
#pragma unroll
    for (int k = 0; k < C::BK / 16; ++k)
      Wgmma<D>::rs(o, p[k], mnmajor<D, C::BK>(v_addr, k), 1);
    wg_commit();
    wg_wait();
    fence_regs(o);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    const float lr = quad_sum(l[r]);
    if (row >= Tq) continue;
    const float den = fmaxf(lr, 1e-30f);
    __nv_bfloat16* orow = out + (static_cast<int64_t>(bh) * Tq + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
          o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
    }
    if ((lane & 3) == 0)
      lse[static_cast<int64_t>(bh) * Tq + row] =
          lr > 0.f ? m[r] * kLn2 + logf(lr) : 0.f;
  }
}

// ------------------------------- backward ---------------------------------

// dq: one block per (b*hq, 64 q rows); Q and dO stay in shared memory, K and
// V tiles come through the ring in order
template <int D>
struct Dq {
  static constexpr int BM = 64;
  static constexpr int BK = 64;
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (2 * STAGES + 1);
};

template <int D>
__global__ void __launch_bounds__(kBlock)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int Hq, int Hkv, int Tq,
                       Mask mask, float sm_scale) {
  using C = Dq<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* do_s = q_s + C::Q_BYTES;
  uint8_t* kv_s = do_s + C::Q_BYTES;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(kv_s + C::STAGES * 2 * C::KV_BYTES);
  uint64_t* full = bars;
  uint64_t* empty = bars + C::STAGES;
  uint64_t* q_bar = bars + 2 * C::STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int q0 = qt * C::BM;
  const int q_first = mask.q_offset + q0;
  const int q_last = mask.q_offset + min(Tq, q0 + C::BM) - 1;
  int lo, hi;
  mask.kv_tiles(q_first, q_last, C::BK, &lo, &hi);
  init_barriers(bars, C::STAGES, 1);

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_bar, 2 * C::Q_BYTES);
      load_tile<D>(q_s, &tm_q, q_bar, q0, bh, C::BM);
      load_tile<D>(do_s, &tm_do, q_bar, q0, bh, C::BM);
      for (int t = lo; t < hi; ++t) {
        const int it = t - lo, s = it % C::STAGES;
        if (it >= C::STAGES) mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
        uint8_t* k_s = kv_s + 2 * s * C::KV_BYTES;
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        load_tile<D>(k_s, &tm_k, &full[s], t * C::BK, bkv, C::BK);
        load_tile<D>(k_s + C::KV_BYTES, &tm_v, &full[s], t * C::BK, bkv, C::BK);
      }
    }
    return;
  }

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const float sl2 = sm_scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    const int64_t ri = static_cast<int64_t>(bh) * Tq + row;
    lse2[r] = row < Tq ? lse[ri] * kLog2e : 0.f;
    dl[r] = row < Tq ? delta[ri] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t q_addr = smem_u32(q_s), do_addr = smem_u32(do_s);
  mbar_wait(q_bar, 0);

  for (int t = lo; t < hi; ++t) {
    const int it = t - lo, s = it % C::STAGES;
    const uint32_t k_addr = smem_u32(kv_s + 2 * s * C::KV_BYTES);
    const uint32_t v_addr = k_addr + C::KV_BYTES;
    mbar_wait(&full[s], (it / C::STAGES) & 1);

    float x[C::BK / 2], dp[C::BK / 2];  // S = Q . K^T, dP = dO . V^T
    wg_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      Wgmma<C::BK>::ss(x, kmajor<D, C::BM>(q_addr, k),
                       kmajor<D, C::BK>(k_addr, k), k > 0);
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      Wgmma<C::BK>::ss(dp, kmajor<D, C::BM>(do_addr, k),
                       kmajor<D, C::BK>(v_addr, k), k > 0);
    wg_commit();
    wg_wait();
    fence_regs(x);
    fence_regs(dp);

    const int k0 = t * C::BK;
    const bool edge = !mask.tile_full(q_first, q_last, k0, k0 + C::BK - 1);
#pragma unroll
    for (int i = 0; i < C::BK / 2; ++i) {
      const int r = frag_row(i);
      float p = exp2f(x[i] * sl2 - lse2[r]);
      if (edge && !mask.visible(mask.q_offset + q0 + r0 + 8 * r,
                                k0 + frag_col(i, lane)))
        p = 0.f;
      x[i] = p * (dp[i] - dl[r]);  // dS, f32
    }
    uint32_t ds[C::BK / 16][4];  // dS rounded to bf16: the A operand of dS . K
    to_operand<C::BK>(x, ds);
    wg_fence();
#pragma unroll
    for (int k = 0; k < C::BK / 16; ++k)
      Wgmma<D>::rs(acc, ds[k], mnmajor<D, C::BK>(k_addr, k), 1);
    wg_commit();
    wg_wait();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= Tq) continue;
    __nv_bfloat16* g = dq + (static_cast<int64_t>(bh) * Tq + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(g + col) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * sm_scale, acc[4 * j + 2 * r + 1] * sm_scale);
    }
  }
}

// dk, dv: one block per (b*hkv, 64 keys); K and V stay in shared memory, the
// group's q heads and each head's visible q tiles come through the ring in
// order (Q, dO by TMA; lse, D by the producer warp's lanes)
template <int D>
struct Dkv {
  static constexpr int BN = 64;                 // keys per block
  static constexpr int BQ = D <= 64 ? 64 : 32;  // q rows per tile
  static constexpr int STAGES = 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int Q_BYTES = BQ * D * 2;
  // Q, dO, then lse and D; rounded up so that every stage's tiles start on
  // a 1024-byte boundary, where the swizzle pattern starts
  static constexpr int STAGE = (2 * Q_BYTES + 2 * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr int SMEM =
      1024 + 2 * KV_BYTES + STAGES * STAGE + 8 * (2 * STAGES + 1);
};

template <int D>
__global__ void __launch_bounds__(kBlock)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Hq, int Hkv,
                         int Tq, Mask mask, float sm_scale) {
  using C = Dkv<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align1024(smem_raw);
  uint8_t* v_s = k_s + C::KV_BYTES;
  uint8_t* st_s = v_s + C::KV_BYTES;  // stage s: Q, dO, lse2[BQ], D[BQ]
  uint64_t* bars = reinterpret_cast<uint64_t*>(st_s + C::STAGES * C::STAGE);
  uint64_t* full = bars;
  uint64_t* empty = bars + C::STAGES;
  uint64_t* kv_bar = bars + 2 * C::STAGES;

  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, hk = bkv - b * Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.x * C::BN;
  const int k_last = min(mask.S, k0 + C::BN) - 1;
  int t_lo, t_hi;
  mask.q_tiles(k0, k_last, Tq, C::BQ, &t_lo, &t_hi);
  const int per_head = t_hi - t_lo;
  init_barriers(bars, C::STAGES, 32);

  if (threadIdx.x >= kConsumers) {  // the producer warp, all 32 lanes
    const int lane = threadIdx.x - kConsumers;
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * C::KV_BYTES);
      load_tile<D>(k_s, &tm_k, kv_bar, k0, bkv, C::BN);
      load_tile<D>(v_s, &tm_v, kv_bar, k0, bkv, C::BN);
    }
    for (int it = 0; it < group * per_head; ++it) {
      const int s = it % C::STAGES;
      const int g = it / per_head, t0 = (t_lo + it % per_head) * C::BQ;
      const int bh = b * Hq + hk * group + g;
      if (it >= C::STAGES) mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
      uint8_t* st = st_s + s * C::STAGE;
      float* lse_s = reinterpret_cast<float*>(st + 2 * C::Q_BYTES);
      for (int c = lane; c < C::BQ; c += 32) {
        const bool ok = t0 + c < Tq;
        const int64_t ri = static_cast<int64_t>(bh) * Tq + t0 + c;
        lse_s[c] = ok ? lse[ri] * kLog2e : 0.f;
        lse_s[C::BQ + c] = ok ? delta[ri] : 0.f;
      }
      if (lane == 0) {  // its arrival carries the byte count of the loads
        mbar_expect_tx(&full[s], 2 * C::Q_BYTES);
        load_tile<D>(st, &tm_q, &full[s], t0, bh, C::BQ);
        load_tile<D>(st + C::Q_BYTES, &tm_do, &full[s], t0, bh, C::BQ);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);  // keys k0 + r0 (+ 8)
  const float sl2 = sm_scale * kLog2e;
  float gk[D / 2], gv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.f;
  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
  mbar_wait(kv_bar, 0);

  for (int it = 0; it < group * per_head; ++it) {
    const int s = it % C::STAGES;
    const int t0 = (t_lo + it % per_head) * C::BQ;
    uint8_t* st = st_s + s * C::STAGE;
    const uint32_t q_addr = smem_u32(st), do_addr = q_addr + C::Q_BYTES;
    const float* lse_s = reinterpret_cast<const float*>(st + 2 * C::Q_BYTES);
    mbar_wait(&full[s], (it / C::STAGES) & 1);

    float x[C::BQ / 2], dp[C::BQ / 2];  // S^T = K . Q^T, dP^T = V . dO^T
    wg_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      Wgmma<C::BQ>::ss(x, kmajor<D, C::BN>(k_addr, k),
                       kmajor<D, C::BQ>(q_addr, k), k > 0);
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      Wgmma<C::BQ>::ss(dp, kmajor<D, C::BN>(v_addr, k),
                       kmajor<D, C::BQ>(do_addr, k), k > 0);
    wg_commit();
    wg_wait();
    fence_regs(x);
    fence_regs(dp);

    const int qa = mask.q_offset + t0;
    const bool edge = !(t0 + C::BQ <= Tq &&
                        mask.tile_full(qa, qa + C::BQ - 1, k0, k0 + C::BN - 1));
#pragma unroll
    for (int i = 0; i < C::BQ / 2; ++i) {
      const int c = frag_col(i, lane);
      float p = exp2f(x[i] * sl2 - lse_s[c]);
      if (edge && !(t0 + c < Tq &&
                    mask.visible(qa + c, k0 + r0 + 8 * frag_row(i))))
        p = 0.f;
      x[i] = p;                            // P^T, f32
      dp[i] = p * (dp[i] - lse_s[C::BQ + c]);  // dS^T, f32
    }
    uint32_t pa[C::BQ / 16][4], da[C::BQ / 16][4];  // both rounded to bf16
    to_operand<C::BQ>(x, pa);
    to_operand<C::BQ>(dp, da);
    wg_fence();
#pragma unroll
    for (int k = 0; k < C::BQ / 16; ++k)
      Wgmma<D>::rs(gv, pa[k], mnmajor<D, C::BQ>(do_addr, k), 1);
#pragma unroll
    for (int k = 0; k < C::BQ / 16; ++k)
      Wgmma<D>::rs(gk, da[k], mnmajor<D, C::BQ>(q_addr, k), 1);
    wg_commit();
    wg_wait();
    fence_regs(gk);
    fence_regs(gv);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + 8 * r;
    if (key >= mask.S) continue;
    const int64_t off = (static_cast<int64_t>(bkv) * mask.S + key) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + col) = __floats2bfloat162_rn(
          gk[4 * j + 2 * r] * sm_scale, gk[4 * j + 2 * r + 1] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
          __floats2bfloat162_rn(gv[4 * j + 2 * r], gv[4 * j + 2 * r + 1]);
    }
  }
}

// ------------------------------- host side --------------------------------

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that the library needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over a contiguous bf16 tensor [heads, rows, D] whose box is
// [rows_per_box, min(D, 64)] of one head, swizzled as Layout<D> says.  A
// box past `rows` zero-fills inside its own head.
template <int D>
bool make_map(CUtensorMap* map, const void* base, int64_t heads, int rows,
              int box_rows) {
  using L = Layout<D>;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(L::kCols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : L::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                     : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raise a kernel's dynamic shared-memory limit to `bytes`, once for each
// device: the attribute stays with the function, so later calls skip it.
// `done` is the caller's, one for each kernel instantiation (bit i: device
// i is set)
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, std::atomic<uint64_t>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done->load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done->fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Hq, int Hkv, int Tq, const Mask& mask,
                float sm_scale, cudaStream_t stream) {
  using C = Fwd<D>;
  if (mask.S == 0) {  // no key: every row is empty, out = 0 and lse = 0
    cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(B) * Hq * Tq * D * 2, stream);
    if (err != cudaSuccess) return err;
    return cudaMemsetAsync(lse, 0, static_cast<size_t>(B) * Hq * Tq * 4, stream);
  }
  CUtensorMap mq, mk, mv;
  if (!make_map<D>(&mq, q, static_cast<int64_t>(B) * Hq, Tq, C::BM) ||
      !make_map<D>(&mk, k, static_cast<int64_t>(B) * Hkv, mask.S, C::BK) ||
      !make_map<D>(&mv, v, static_cast<int64_t>(B) * Hkv, mask.S, C::BK))
    return cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = allow_smem(flash_fwd_tc_kernel<D>, C::SMEM, &smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(Tq, C::BM), B * Hq);
  flash_fwd_tc_kernel<D><<<grid, kBlock, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, Hq, Hkv, Tq, mask,
      sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int B, int Hq, int Hkv, int Tq,
                const Mask& mask, float sm_scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  if (mask.S == 0)  // no key: dq = 0 (dk and dv have no element)
    return cudaMemsetAsync(dq, 0, static_cast<size_t>(B) * Hq * Tq * D * 2,
                           stream);
  const int64_t rows = static_cast<int64_t>(B) * Hq * Tq;
  flash_bwd_delta_kernel<T, D><<<cdiv(rows, kThreads / 32), kThreads, 0,
                                 stream>>>(static_cast<const T*>(out),
                                           static_cast<const T*>(dout), delta,
                                           rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t bhq = static_cast<int64_t>(B) * Hq, bhk = static_cast<int64_t>(B) * Hkv;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map<D>(&mq, q, bhq, Tq, Dkv<D>::BQ) ||
      !make_map<D>(&mdo, dout, bhq, Tq, Dkv<D>::BQ) ||
      !make_map<D>(&mk, k, bhk, mask.S, Dkv<D>::BN) ||
      !make_map<D>(&mv, v, bhk, mask.S, Dkv<D>::BN))
    return cudaErrorInvalidValue;
  static std::atomic<uint64_t> dkdv_smem_set{0}, dq_smem_set{0};
  err = allow_smem(flash_bwd_dkdv_tc_kernel<D>, Dkv<D>::SMEM, &dkdv_smem_set);
  if (err != cudaSuccess) return err;
  const dim3 gkv(cdiv(mask.S, Dkv<D>::BN), B * Hkv);
  flash_bwd_dkdv_tc_kernel<D><<<gkv, kBlock, Dkv<D>::SMEM, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Hq, Hkv, Tq, mask, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the dq kernel's boxes: 64 keys, as the dK/dV kernel's; 64 q rows, which
  // differ from its q tile only at d = 128
  static_assert(Dq<D>::BK == Dkv<D>::BN, "the K/V maps serve both kernels");
  if constexpr (Dq<D>::BM != Dkv<D>::BQ) {
    if (!make_map<D>(&mq, q, bhq, Tq, Dq<D>::BM) ||
        !make_map<D>(&mdo, dout, bhq, Tq, Dq<D>::BM))
      return cudaErrorInvalidValue;
  }
  err = allow_smem(flash_bwd_dq_tc_kernel<D>, Dq<D>::SMEM, &dq_smem_set);
  if (err != cudaSuccess) return err;
  const dim3 gq(cdiv(Tq, Dq<D>::BM), B * Hq);
  flash_bwd_dq_tc_kernel<D><<<gq, kBlock, Dq<D>::SMEM, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<T*>(dq), Hq, Hkv, Tq, mask,
      sm_scale);
  return cudaGetLastError();
}

// The tile plan of the kernels above at head dim D, on the host: for each
// q block i of the forward and dQ kernels, kv[2i], kv[2i + 1] = [lo, hi) of
// its kv tiles and kv_full[i * n_kv + t] = 1 where kv tile t takes no
// element mask; for each key block j of the dK/dV kernel, qt[2j],
// qt[2j + 1] = [lo, hi) of its q tiles and q_full[j * n_qt + t] likewise
// (n_kv = cdiv(S, 64), n_qt = cdiv(Tq, bq)).  Returns bq, the dK/dV
// kernel's q rows per tile, and writes nothing where kv is null.
template <int D>
int tile_plan(int Tq, const Mask& mask, int* kv, unsigned char* kv_full,
              int* qt, unsigned char* q_full) {
  static_assert(Fwd<D>::BM == Dq<D>::BM && Fwd<D>::BK == Dq<D>::BK,
                "the forward and dQ kernels share their tiles");
  constexpr int BM = Fwd<D>::BM, BK = Fwd<D>::BK;
  constexpr int BN = Dkv<D>::BN, BQ = Dkv<D>::BQ;
  if (kv == nullptr) return BQ;
  const int n_kv = cdiv(mask.S, BK), n_qt = cdiv(Tq, BQ);
  for (int i = 0; i < cdiv(Tq, BM); ++i) {
    const int q0 = i * BM, q_end = Tq < q0 + BM ? Tq : q0 + BM;
    const int q_first = mask.q_offset + q0, q_last = mask.q_offset + q_end - 1;
    mask.kv_tiles(q_first, q_last, BK, &kv[2 * i], &kv[2 * i + 1]);
    for (int t = kv[2 * i]; t < kv[2 * i + 1]; ++t)
      kv_full[i * n_kv + t] =
          mask.tile_full(q_first, q_last, t * BK, t * BK + BK - 1);
  }
  for (int j = 0; j < cdiv(mask.S, BN); ++j) {
    const int k0 = j * BN, k_last = (mask.S < k0 + BN ? mask.S : k0 + BN) - 1;
    mask.q_tiles(k0, k_last, Tq, BQ, &qt[2 * j], &qt[2 * j + 1]);
    for (int t = qt[2 * j]; t < qt[2 * j + 1]; ++t) {
      const int qa = mask.q_offset + t * BQ;
      q_full[j * n_qt + t] = t * BQ + BQ <= Tq &&
                             mask.tile_full(qa, qa + BQ - 1, k0, k0 + BN - 1);
    }
  }
  return BQ;
}

}  // namespace tc

// dtype 0 (f32) runs the SIMT kernels, dtype 1 (bf16) the tensor-core ones
#define FA_DISPATCH(DTYPE, D, CALL_F32, CALL_BF16)                          \
  do {                                                                      \
    if (DTYPE == 0) {                                                       \
      using T = float;                                                      \
      switch (D) {                                                          \
        case 16: { constexpr int HD = 16; return CALL_F32; }                \
        case 32: { constexpr int HD = 32; return CALL_F32; }                \
        case 64: { constexpr int HD = 64; return CALL_F32; }                \
        case 128: { constexpr int HD = 128; return CALL_F32; }              \
      }                                                                     \
    } else if (DTYPE == 1) {                                                \
      switch (D) {                                                          \
        case 16: { constexpr int HD = 16; return CALL_BF16; }               \
        case 32: { constexpr int HD = 32; return CALL_BF16; }               \
        case 64: { constexpr int HD = 64; return CALL_BF16; }               \
        case 128: { constexpr int HD = 128; return CALL_BF16; }             \
      }                                                                     \
    }                                                                       \
    return static_cast<int>(cudaErrorInvalidValue);                         \
  } while (0)

}  // namespace

// dtype codes: 0 = f32, 1 = bf16; head dims 16, 32, 64, 128.  Tensors are
// contiguous [B, H, T|S, D]; bf16 ones 16-byte aligned (TMA).  Returns the
// cudaError_t of the launches (0 on success); shapes are checked by the
// caller.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, float* lse, int B,
    int Hq, int Hkv, int Tq, int S, int D, int causal, int window,
    int q_offset, float sm_scale, int dtype, void* stream) {
  if (B * Hq == 0 || Tq == 0) return 0;
  if (Hkv < 1 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const Mask mask{S, causal, window, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(dtype, D,
              static_cast<int>((fwd<T, HD>(q, k, v, out, lse, B, Hq, Hkv, Tq,
                                           mask, sm_scale, s))),
              static_cast<int>((tc::fwd<HD>(q, k, v, out, lse, B, Hq, Hkv, Tq,
                                            mask, sm_scale, s))));
}

// delta is f32 scratch [B, Hq, T]; dq is [B, Hq, T, D], dk/dv [B, Hkv, S, D].
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int Tq, int S, int D, int causal,
    int window, int q_offset, float sm_scale, int dtype, void* stream) {
  if (B * Hq == 0) return 0;
  if (Hkv < 1 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  if (Tq == 0) {  // no query: dk = dv = 0
    const size_t n = static_cast<size_t>(B) * Hkv * S * D * (dtype ? 2 : 4);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(dk, 0, n, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, n, s);
    return static_cast<int>(err);
  }
  const Mask mask{S, causal, window, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(dtype, D,
              static_cast<int>((bwd<T, HD>(q, k, v, out, dout, lse, delta, dq,
                                           dk, dv, B, Hq, Hkv, Tq, mask,
                                           sm_scale, s))),
              static_cast<int>((tc::bwd<HD>(q, k, v, out, dout, lse, delta,
                                            dq, dk, dv, B, Hq, Hkv, Tq, mask,
                                            sm_scale, s))));
}

// The bf16 kernels' tile plan (tc::tile_plan), computed on the host by the
// Mask functions the kernels run; chip_smoke.py holds it against the
// element mask.  Returns -1 for a head dim the kernels do not take.
extern "C" int flash_attention_tile_plan(int Tq, int S, int D, int causal,
                                         int window, int q_offset, int* kv,
                                         unsigned char* kv_full, int* qt,
                                         unsigned char* q_full) {
  const Mask mask{S, causal, window, q_offset};
  switch (D) {
    case 16: return tc::tile_plan<16>(Tq, mask, kv, kv_full, qt, q_full);
    case 32: return tc::tile_plan<32>(Tq, mask, kv, kv_full, qt, q_full);
    case 64: return tc::tile_plan<64>(Tq, mask, kv, kv_full, qt, q_full);
    case 128: return tc::tile_plan<128>(Tq, mask, kv, kv_full, qt, q_full);
  }
  return -1;
}
