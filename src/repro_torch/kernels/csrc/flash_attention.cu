// GQA flash attention for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel).  q and k are d wide, v and the
// output dv wide, for every (d, dv) pair of FA_SHAPES below: the widths
// the model configs reach, (80, 80) for hubert-xlarge, (192, 128) for
// deepseek-v2's MLA (qk_nope 128 + qk_rope 64 against v 128) and (48, 32)
// for its reduced config among them.  sm_scale is d^-0.5.  The forward
// computes the same function:
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
//   by 3-D tensor maps [B*H, T|S, width], so a ragged tail zero-fills
//   inside its own head.  A tile's width is cut into column panels
//   (hopper.cuh, Panels): 64-column panels swizzled over 128 B, then at
//   most one of 32 columns (64 B) and one of 16 (32 B), each panel its own
//   TMA box through a map of its kind (d 80 = 64 + 16, 48 = 32 + 16, 192 =
//   3 x 64; d 128 is two 64-column panels).  The wgmma descriptors read
//   the panels K-major, each k16 step of a reduction along the width from
//   the one panel that holds it, or, for the operand reduced along its rows
//   (V, dO, Q, K), MN-major: a product whose output width spans panels of
//   two swizzles is issued once per kind (one product over the run of
//   64-column panels, one for a 32-column panel, one for a 16-column
//   panel), each into its own columns of the f32 accumulator.
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
//       and each head's visible q tiles (64 rows; 32 once d or dv passes
//       64, where at (192, 128) the 64 x 192 and 64 x 128 f32 accumulators
//       take 160 registers a thread) in order:
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
//   (simt_tpr: the fewest, a power of two, that leave a thread at most 64
//   columns of q and of acc in whole float4s: 1 up to d 64, 2 at d 80 and
//   128, 4 at (192, 128); the backward's at most 32) holding q and acc in
//   registers,
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

// stage rows [r0, r0 + rows) of a [n, W] matrix into f32 shared memory,
// zero past n, optionally scaled
template <typename T, int W>
__device__ __forceinline__ void stage(float (*dst)[W], const T* src, int r0,
                                      int rows, int n, float scale) {
  for (int e = threadIdx.x; e < rows * W; e += kThreads) {
    const int j = e / W, c = e - j * W;
    const int r = r0 + j;
    dst[j][c] = r < n ? to_f32(src[static_cast<int64_t>(r) * W + c]) * scale
                      : 0.f;
  }
}

// Threads per q row (forward) or per key / q row (backward) of the SIMT
// kernels: the fewest, a power of two, that leave each thread at most
// `most` columns of q/k and of v, in slices of whole float4s
__host__ __device__ constexpr int simt_tpr(int dk, int dv, int most) {
  int t = 1;
  while ((dk > dv ? dk : dv) > most * t || dk % (4 * t) || dv % (4 * t)) t *= 2;
  return t;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q,   // [B, Hq, T, DK]
                 const T* __restrict__ k,   // [B, Hkv, S, DK]
                 const T* __restrict__ v,   // [B, Hkv, S, DV]
                 T* __restrict__ out,       // [B, Hq, T, DV]
                 float* __restrict__ lse,   // [B, Hq, T]
                 int Hq, int Hkv, int Tq, Mask mask, float sm_scale) {
  constexpr int TPR = simt_tpr(DK, DV, 64);  // threads per q row
  constexpr int DTK = DK / TPR, DTV = DV / TPR;  // columns each thread holds
  constexpr int BQ = kThreads / TPR;             // q rows per block
  __shared__ __align__(16) float k_s[kTile][DK];
  __shared__ __align__(16) float v_s[kTile][DV];

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int dk0 = (tid % TPR) * DTK, dv0 = (tid % TPR) * DTV;
  const int row = blockIdx.x * BQ + tid / TPR;
  const bool row_ok = row < Tq;
  const int qpos = mask.q_offset + row;

  float qr[DTK], acc[DTV];
  const T* qrow = q + (static_cast<int64_t>(bh) * Tq + (row_ok ? row : 0)) * DK + dk0;
#pragma unroll
  for (int i = 0; i < DTK; ++i) qr[i] = row_ok ? to_f32(qrow[i]) * sm_scale : 0.f;
#pragma unroll
  for (int i = 0; i < DTV; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  const int q_first = mask.q_offset + blockIdx.x * BQ;
  const int q_last = mask.q_offset + min(Tq, (blockIdx.x + 1) * BQ) - 1;
  int lo, hi;
  mask.kv_tiles(q_first, q_last, kTile, &lo, &hi);
  const T* kb = k + static_cast<int64_t>(bkv) * mask.S * DK;
  const T* vb = v + static_cast<int64_t>(bkv) * mask.S * DV;

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile is consumed
    stage<T, DK>(k_s, kb, k0, kTile, mask.S, 1.f);
    stage<T, DV>(v_s, vb, k0, kTile, mask.S, 1.f);
    __syncthreads();

    float s[kTile];
    unsigned vis = 0u;
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float a = row_sum<TPR>(dot_smem<DTK>(qr, &k_s[j][dk0]));
      const bool ok = mask.visible(qpos, k0 + j);
      vis |= ok ? (1u << j) : 0u;
      s[j] = ok ? a : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < DTV; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = (vis >> j) & 1u ? expf(s[j] - m_new) : 0.f;
      psum += p;
      const float* vr = &v_s[j][dv0];
#pragma unroll
      for (int i = 0; i < DTV; i += 4) {
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
    T* orow = out + (static_cast<int64_t>(bh) * Tq + row) * DV + dv0;
#pragma unroll
    for (int i = 0; i < DTV; ++i) orow[i] = from_f32<T>(acc[i] / denom);
    if (tid % TPR == 0)
      lse[static_cast<int64_t>(bh) * Tq + row] = l > 0.f ? m + logf(l) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// D_i = sum_c dout_ic * out_ic, one warp per row of DV columns
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                    threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* o = out + r * DV;
  const T* g = dout + r * DV;
  float a = 0.f;
  for (int c = lane; c < DV; c += 32) a += to_f32(o[c]) * to_f32(g[c]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) a += __shfl_xor_sync(0xffffffffu, a, w);
  if (lane == 0) delta[r] = a;
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Hq, int Hkv, int Tq, Mask mask,
                      float sm_scale) {
  constexpr int TPR = simt_tpr(DK, DV, 32);  // threads per key
  constexpr int DTK = DK / TPR, DTV = DV / TPR;
  constexpr int BKV = kThreads / TPR;  // keys per block
  constexpr int BQ = 32;               // q rows per shared-memory tile
  __shared__ __align__(16) float q_s[BQ][DK];
  __shared__ __align__(16) float g_s[BQ][DV];
  __shared__ float lse_s[BQ];
  __shared__ float del_s[BQ];

  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, hk = bkv - b * Hkv;
  const int group = Hq / Hkv;
  const int tid = threadIdx.x;
  const int dk0 = (tid % TPR) * DTK, dv0 = (tid % TPR) * DTV;
  const int key = blockIdx.x * BKV + tid / TPR;
  const bool key_ok = key < mask.S;

  float kr[DTK], vr[DTV], dkr[DTK], dvr[DTV];
  const int64_t krow = static_cast<int64_t>(bkv) * mask.S + (key_ok ? key : 0);
  const int64_t koff = krow * DK + dk0, voff = krow * DV + dv0;
#pragma unroll
  for (int i = 0; i < DTK; ++i) {
    kr[i] = key_ok ? to_f32(k[koff + i]) : 0.f;
    dkr[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DTV; ++i) {
    vr[i] = key_ok ? to_f32(v[voff + i]) : 0.f;
    dvr[i] = 0.f;
  }
  const int k_first = blockIdx.x * BKV;
  const int k_last = min(mask.S, k_first + BKV) - 1;
  int i_lo, i_hi;
  mask.q_rows(k_first, k_last, Tq, &i_lo, &i_hi);

  for (int g = 0; g < group; ++g) {
    const int64_t bh = static_cast<int64_t>(b) * Hq + hk * group + g;
    const T* qh = q + bh * Tq * DK;
    const T* gh = dout + bh * Tq * DV;
    for (int t0 = i_lo; t0 < i_hi; t0 += BQ) {
      const int rows = min(BQ, i_hi - t0);
      __syncthreads();
      stage<T, DK>(q_s, qh, t0, BQ, Tq, sm_scale);
      stage<T, DV>(g_s, gh, t0, BQ, Tq, 1.f);
      if (tid < BQ) {
        const bool ok = t0 + tid < Tq;
        lse_s[tid] = ok ? lse[bh * Tq + t0 + tid] : 0.f;
        del_s[tid] = ok ? delta[bh * Tq + t0 + tid] : 0.f;
      }
      __syncthreads();
      for (int r = 0; r < rows; ++r) {  // uniform over the block
        const float s = row_sum<TPR>(dot_smem<DTK>(kr, &q_s[r][dk0]));
        const float dp = row_sum<TPR>(dot_smem<DTV>(vr, &g_s[r][dv0]));
        const bool ok = key_ok && mask.visible(mask.q_offset + t0 + r, key);
        const float p = ok ? expf(s - lse_s[r]) : 0.f;
        const float ds = p * (dp - del_s[r]);
        const float* qs = &q_s[r][dk0];
        const float* gs = &g_s[r][dv0];
#pragma unroll
        for (int i = 0; i < DTV; i += 4) {
          const float4 a = *reinterpret_cast<const float4*>(gs + i);
          dvr[i] += p * a.x;
          dvr[i + 1] += p * a.y;
          dvr[i + 2] += p * a.z;
          dvr[i + 3] += p * a.w;
        }
#pragma unroll
        for (int i = 0; i < DTK; i += 4) {
          const float4 c = *reinterpret_cast<const float4*>(qs + i);
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
    for (int i = 0; i < DTK; ++i) dk[koff + i] = from_f32<T>(dkr[i]);
#pragma unroll
    for (int i = 0; i < DTV; ++i) dv[voff + i] = from_f32<T>(dvr[i]);
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Hq, int Hkv, int Tq, Mask mask, float sm_scale) {
  constexpr int TPR = simt_tpr(DK, DV, 32);  // threads per q row
  constexpr int DTK = DK / TPR, DTV = DV / TPR;
  constexpr int BQ = kThreads / TPR;
  __shared__ __align__(16) float k_s[kTile][DK];
  __shared__ __align__(16) float v_s[kTile][DV];

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int dk0 = (tid % TPR) * DTK, dv0 = (tid % TPR) * DTV;
  const int row = blockIdx.x * BQ + tid / TPR;
  const bool row_ok = row < Tq;
  const int qpos = mask.q_offset + row;

  const int64_t ridx = static_cast<int64_t>(bh) * Tq + (row_ok ? row : 0);
  const int64_t roff = ridx * DK + dk0, goff = ridx * DV + dv0;
  float qr[DTK], gr[DTV], dqr[DTK];
#pragma unroll
  for (int i = 0; i < DTK; ++i) {
    qr[i] = row_ok ? to_f32(q[roff + i]) * sm_scale : 0.f;
    dqr[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DTV; ++i) gr[i] = row_ok ? to_f32(dout[goff + i]) : 0.f;
  const float lse_r = row_ok ? lse[ridx] : 0.f;
  const float del_r = row_ok ? delta[ridx] : 0.f;

  const int q_first = mask.q_offset + blockIdx.x * BQ;
  const int q_last = mask.q_offset + min(Tq, (blockIdx.x + 1) * BQ) - 1;
  int lo, hi;
  mask.kv_tiles(q_first, q_last, kTile, &lo, &hi);
  const T* kb = k + static_cast<int64_t>(bkv) * mask.S * DK;
  const T* vb = v + static_cast<int64_t>(bkv) * mask.S * DV;

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    stage<T, DK>(k_s, kb, k0, kTile, mask.S, 1.f);
    stage<T, DV>(v_s, vb, k0, kTile, mask.S, 1.f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float s = row_sum<TPR>(dot_smem<DTK>(qr, &k_s[j][dk0]));
      const float dp = row_sum<TPR>(dot_smem<DTV>(gr, &v_s[j][dv0]));
      const bool ok = row_ok && mask.visible(qpos, k0 + j);
      const float p = ok ? expf(s - lse_r) : 0.f;
      const float ds = p * (dp - del_r);
      const float* kr = &k_s[j][dk0];
#pragma unroll
      for (int i = 0; i < DTK; i += 4) {
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
    for (int i = 0; i < DTK; ++i) dq[roff + i] = from_f32<T>(dqr[i] * sm_scale);
  }
}

inline int cdiv(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }

template <typename T, int DK, int DV>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Hq, int Hkv, int Tq, const Mask& mask,
                float sm_scale, cudaStream_t stream) {
  constexpr int TPR = simt_tpr(DK, DV, 64);
  const dim3 grid(cdiv(Tq, kThreads / TPR), B * Hq);
  flash_fwd_kernel<T, DK, DV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Hq, Hkv, Tq, mask,
      sm_scale);
  return cudaGetLastError();
}

template <typename T, int DK, int DV>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int B, int Hq, int Hkv, int Tq,
                const Mask& mask, float sm_scale, cudaStream_t stream) {
  constexpr int TPR = simt_tpr(DK, DV, 32);
  const int64_t rows = static_cast<int64_t>(B) * Hq * Tq;
  flash_bwd_delta_kernel<T, DV><<<cdiv(rows, kThreads / 32), kThreads, 0,
                                 stream>>>(static_cast<const T*>(out),
                                           static_cast<const T*>(dout), delta,
                                           rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (mask.S > 0) {
    const dim3 gkv(cdiv(mask.S, kThreads / TPR), B * Hkv);
    flash_bwd_dkdv_kernel<T, DK, DV><<<gkv, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv, Tq, mask, sm_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 gq(cdiv(Tq, kThreads / TPR), B * Hq);
  flash_bwd_dq_kernel<T, DK, DV><<<gq, kThreads, 0, stream>>>(
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

template <int DK, int DV>
struct Fwd {
  static constexpr int BM = 64;                 // q rows per block
  // keys per kv tile: at 64 a thread holds 32 scores, the kernel ~100
  // registers, and three blocks share an SM; at 128, two
  static constexpr int BK = 64;
  static constexpr int STAGES = 2;  // depth of the TMA ring
  static constexpr int Q_BYTES = BM * DK * 2;
  static constexpr int K_BYTES = BK * DK * 2;
  static constexpr int KV_BYTES = K_BYTES + BK * DV * 2;  // a stage: K, V
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * KV_BYTES + 8 * (2 * STAGES + 1);
};

template <int DK, int DV>
__global__ void __launch_bounds__(kBlock)
flash_fwd_tc_kernel(const __grid_constant__ TMaps<DK> tm_q,
                    const __grid_constant__ TMaps<DK> tm_k,
                    const __grid_constant__ TMaps<DV> tm_v,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int Hq, int Hkv, int Tq, Mask mask, float sm_scale) {
  using C = Fwd<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* kv_s = q_s + C::Q_BYTES;  // stage s: K, then V
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(kv_s + C::STAGES * C::KV_BYTES);
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
      load_tile<DK>(q_s, tm_q, q_bar, q0, bh, C::BM);
      for (int t = lo; t < hi; ++t) {
        const int it = t - lo, s = it % C::STAGES;
        if (it >= C::STAGES) mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
        uint8_t* k_s = kv_s + s * C::KV_BYTES;
        mbar_expect_tx(&full[s], C::KV_BYTES);
        load_tile<DK>(k_s, tm_k, &full[s], t * C::BK, bkv, C::BK);
        load_tile<DV>(k_s + C::K_BYTES, tm_v, &full[s], t * C::BK, bkv, C::BK);
      }
    }
    return;
  }

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);  // rows r0, r0 + 8
  const float sl2 = sm_scale * kLog2e;  // scores in log2 units: exp2f
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(q_s);
  mbar_wait(q_bar, 0);

  for (int t = lo; t < hi; ++t) {
    const int it = t - lo, s = it % C::STAGES;
    const uint32_t k_addr = smem_u32(kv_s + s * C::KV_BYTES);
    const uint32_t v_addr = k_addr + C::K_BYTES;
    mbar_wait(&full[s], (it / C::STAGES) & 1);

    float x[C::BK / 2];  // S = Q . K^T, f32
    wg_fence();
#pragma unroll
    for (int k = 0; k < DK / 16; ++k)
      Wgmma<C::BK>::ss(x, kmajor<DK, C::BM>(q_addr, k),
                       kmajor<DK, C::BK>(k_addr, k), k > 0);
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
    for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[frag_row(i)];
    wg_fence();
#pragma unroll
    for (int k = 0; k < C::BK / 16; ++k)
      rs_panels<DV, C::BK>(o, p[k], v_addr, k);
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
    __nv_bfloat16* orow = out + (static_cast<int64_t>(bh) * Tq + row) * DV;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
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
template <int DK, int DV>
struct Dq {
  static constexpr int BM = 64;
  static constexpr int BK = 64;
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = BM * DK * 2;
  static constexpr int DO_BYTES = BM * DV * 2;
  static constexpr int K_BYTES = BK * DK * 2;
  static constexpr int KV_BYTES = K_BYTES + BK * DV * 2;  // a stage: K, V
  static constexpr int SMEM = 1024 + Q_BYTES + DO_BYTES + STAGES * KV_BYTES +
                              8 * (2 * STAGES + 1);
};

template <int DK, int DV>
__global__ void __launch_bounds__(kBlock)
flash_bwd_dq_tc_kernel(const __grid_constant__ TMaps<DK> tm_q,
                       const __grid_constant__ TMaps<DK> tm_k,
                       const __grid_constant__ TMaps<DV> tm_v,
                       const __grid_constant__ TMaps<DV> tm_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int Hq, int Hkv, int Tq,
                       Mask mask, float sm_scale) {
  using C = Dq<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* do_s = q_s + C::Q_BYTES;
  uint8_t* kv_s = do_s + C::DO_BYTES;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(kv_s + C::STAGES * C::KV_BYTES);
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
      mbar_expect_tx(q_bar, C::Q_BYTES + C::DO_BYTES);
      load_tile<DK>(q_s, tm_q, q_bar, q0, bh, C::BM);
      load_tile<DV>(do_s, tm_do, q_bar, q0, bh, C::BM);
      for (int t = lo; t < hi; ++t) {
        const int it = t - lo, s = it % C::STAGES;
        if (it >= C::STAGES) mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
        uint8_t* k_s = kv_s + s * C::KV_BYTES;
        mbar_expect_tx(&full[s], C::KV_BYTES);
        load_tile<DK>(k_s, tm_k, &full[s], t * C::BK, bkv, C::BK);
        load_tile<DV>(k_s + C::K_BYTES, tm_v, &full[s], t * C::BK, bkv, C::BK);
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
  float acc[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) acc[i] = 0.f;
  const uint32_t q_addr = smem_u32(q_s), do_addr = smem_u32(do_s);
  mbar_wait(q_bar, 0);

  for (int t = lo; t < hi; ++t) {
    const int it = t - lo, s = it % C::STAGES;
    const uint32_t k_addr = smem_u32(kv_s + s * C::KV_BYTES);
    const uint32_t v_addr = k_addr + C::K_BYTES;
    mbar_wait(&full[s], (it / C::STAGES) & 1);

    float x[C::BK / 2], dp[C::BK / 2];  // S = Q . K^T, dP = dO . V^T
    wg_fence();
#pragma unroll
    for (int k = 0; k < DK / 16; ++k)
      Wgmma<C::BK>::ss(x, kmajor<DK, C::BM>(q_addr, k),
                       kmajor<DK, C::BK>(k_addr, k), k > 0);
#pragma unroll
    for (int k = 0; k < DV / 16; ++k)
      Wgmma<C::BK>::ss(dp, kmajor<DV, C::BM>(do_addr, k),
                       kmajor<DV, C::BK>(v_addr, k), k > 0);
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
      rs_panels<DK, C::BK>(acc, ds[k], k_addr, k);
    wg_commit();
    wg_wait();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= Tq) continue;
    __nv_bfloat16* g = dq + (static_cast<int64_t>(bh) * Tq + row) * DK;
#pragma unroll
    for (int j = 0; j < DK / 8; ++j) {
      const int col = 8 * j + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(g + col) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * sm_scale, acc[4 * j + 2 * r + 1] * sm_scale);
    }
  }
}

// dk, dv: one block per (b*hkv, 64 keys); K and V stay in shared memory, the
// group's q heads and each head's visible q tiles come through the ring in
// order (Q, dO by TMA; lse, D by the producer warp's lanes)
template <int DK, int DV>
struct Dkv {
  static constexpr int BN = 64;  // keys per block
  // q rows per tile: 64 up to 64 columns; 32 beyond, where the dK and dV
  // accumulators (64 x DK and 64 x DV f32 in one warpgroup) leave room for
  // no more than a 64 x 32 score tile and its dP
  static constexpr int BQ = DK <= 64 && DV <= 64 ? 64 : 32;
  static constexpr int STAGES = 2;
  static constexpr int K_BYTES = BN * DK * 2;
  static constexpr int V_BYTES = BN * DV * 2;
  static constexpr int Q_BYTES = BQ * DK * 2;
  static constexpr int DO_BYTES = BQ * DV * 2;
  // Q, dO, then lse and D; rounded up so that every stage's tiles start on
  // a 1024-byte boundary, where the swizzle pattern starts
  static constexpr int STAGE =
      (Q_BYTES + DO_BYTES + 2 * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr int SMEM =
      1024 + K_BYTES + V_BYTES + STAGES * STAGE + 8 * (2 * STAGES + 1);
};

template <int DK, int DV>
__global__ void __launch_bounds__(kBlock)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ TMaps<DK> tm_q,
                         const __grid_constant__ TMaps<DK> tm_k,
                         const __grid_constant__ TMaps<DV> tm_v,
                         const __grid_constant__ TMaps<DV> tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Hq, int Hkv,
                         int Tq, Mask mask, float sm_scale) {
  using C = Dkv<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align1024(smem_raw);
  uint8_t* v_s = k_s + C::K_BYTES;
  uint8_t* st_s = v_s + C::V_BYTES;  // stage s: Q, dO, lse2[BQ], D[BQ]
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
      mbar_expect_tx(kv_bar, C::K_BYTES + C::V_BYTES);
      load_tile<DK>(k_s, tm_k, kv_bar, k0, bkv, C::BN);
      load_tile<DV>(v_s, tm_v, kv_bar, k0, bkv, C::BN);
    }
    for (int it = 0; it < group * per_head; ++it) {
      const int s = it % C::STAGES;
      const int g = it / per_head, t0 = (t_lo + it % per_head) * C::BQ;
      const int bh = b * Hq + hk * group + g;
      if (it >= C::STAGES) mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
      uint8_t* st = st_s + s * C::STAGE;
      float* lse_s = reinterpret_cast<float*>(st + C::Q_BYTES + C::DO_BYTES);
      for (int c = lane; c < C::BQ; c += 32) {
        const bool ok = t0 + c < Tq;
        const int64_t ri = static_cast<int64_t>(bh) * Tq + t0 + c;
        lse_s[c] = ok ? lse[ri] * kLog2e : 0.f;
        lse_s[C::BQ + c] = ok ? delta[ri] : 0.f;
      }
      if (lane == 0) {  // its arrival carries the byte count of the loads
        mbar_expect_tx(&full[s], C::Q_BYTES + C::DO_BYTES);
        load_tile<DK>(st, tm_q, &full[s], t0, bh, C::BQ);
        load_tile<DV>(st + C::Q_BYTES, tm_do, &full[s], t0, bh, C::BQ);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);  // keys k0 + r0 (+ 8)
  const float sl2 = sm_scale * kLog2e;
  float gk[DK / 2], gv[DV / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) gk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) gv[i] = 0.f;
  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
  mbar_wait(kv_bar, 0);

  for (int it = 0; it < group * per_head; ++it) {
    const int s = it % C::STAGES;
    const int t0 = (t_lo + it % per_head) * C::BQ;
    uint8_t* st = st_s + s * C::STAGE;
    const uint32_t q_addr = smem_u32(st), do_addr = q_addr + C::Q_BYTES;
    const float* lse_s =
        reinterpret_cast<const float*>(st + C::Q_BYTES + C::DO_BYTES);
    mbar_wait(&full[s], (it / C::STAGES) & 1);

    float x[C::BQ / 2], dp[C::BQ / 2];  // S^T = K . Q^T, dP^T = V . dO^T
    wg_fence();
#pragma unroll
    for (int k = 0; k < DK / 16; ++k)
      Wgmma<C::BQ>::ss(x, kmajor<DK, C::BN>(k_addr, k),
                       kmajor<DK, C::BQ>(q_addr, k), k > 0);
#pragma unroll
    for (int k = 0; k < DV / 16; ++k)
      Wgmma<C::BQ>::ss(dp, kmajor<DV, C::BN>(v_addr, k),
                       kmajor<DV, C::BQ>(do_addr, k), k > 0);
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
      rs_panels<DV, C::BQ>(gv, pa[k], do_addr, k);
#pragma unroll
    for (int k = 0; k < C::BQ / 16; ++k)
      rs_panels<DK, C::BQ>(gk, da[k], q_addr, k);
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
    const int64_t row = static_cast<int64_t>(bkv) * mask.S + key;
#pragma unroll
    for (int j = 0; j < DK / 8; ++j) {
      const int col = 8 * j + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(dk + row * DK + col) =
          __floats2bfloat162_rn(gk[4 * j + 2 * r] * sm_scale,
                                gk[4 * j + 2 * r + 1] * sm_scale);
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(dv + row * DV + col) =
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

// The tensor maps of a contiguous bf16 tensor [heads, rows, W], one per
// panel kind (Panels<W>): each a 3-D map whose box is [that panel's width,
// rows_per_box] of one head, swizzled over the panel's row bytes.  A box
// past `rows` zero-fills inside its own head.
template <int W>
bool make_map(TMaps<W>* maps, const void* base, int64_t heads, int rows,
              int box_rows) {
  using P = Panels<W>;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * 2,
                                 static_cast<cuuint64_t>(rows) * W * 2};
  const cuuint32_t elem[3] = {1, 1, 1};
  const int widths[3] = {P::kN64 > 0 ? 64 : 0, P::kHas32 ? 32 : 0,
                         P::kHas16 ? 16 : 0};
  int i = 0;
  for (int pw : widths) {
    if (pw == 0) continue;
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(pw),
                               static_cast<cuuint32_t>(box_rows), 1};
    const CUtensorMapSwizzle sw = pw == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : pw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
    if (fn(&maps->m[i++], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
           const_cast<void*>(base), dims, strides, box, elem,
           CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
  }
  return true;
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

template <int DK, int DV>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Hq, int Hkv, int Tq, const Mask& mask,
                float sm_scale, cudaStream_t stream) {
  using C = Fwd<DK, DV>;
  if (mask.S == 0) {  // no key: every row is empty, out = 0 and lse = 0
    cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(B) * Hq * Tq * DV * 2, stream);
    if (err != cudaSuccess) return err;
    return cudaMemsetAsync(lse, 0, static_cast<size_t>(B) * Hq * Tq * 4, stream);
  }
  TMaps<DK> mq, mk;
  TMaps<DV> mv;
  if (!make_map<DK>(&mq, q, static_cast<int64_t>(B) * Hq, Tq, C::BM) ||
      !make_map<DK>(&mk, k, static_cast<int64_t>(B) * Hkv, mask.S, C::BK) ||
      !make_map<DV>(&mv, v, static_cast<int64_t>(B) * Hkv, mask.S, C::BK))
    return cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = allow_smem(flash_fwd_tc_kernel<DK, DV>, C::SMEM, &smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(Tq, C::BM), B * Hq);
  flash_fwd_tc_kernel<DK, DV><<<grid, kBlock, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, Hq, Hkv, Tq, mask,
      sm_scale);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int B, int Hq, int Hkv, int Tq,
                const Mask& mask, float sm_scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  using Ckv = Dkv<DK, DV>;
  using Cq = Dq<DK, DV>;
  if (mask.S == 0)  // no key: dq = 0 (dk and dv have no element)
    return cudaMemsetAsync(dq, 0, static_cast<size_t>(B) * Hq * Tq * DK * 2,
                           stream);
  const int64_t rows = static_cast<int64_t>(B) * Hq * Tq;
  flash_bwd_delta_kernel<T, DV><<<cdiv(rows, kThreads / 32), kThreads, 0,
                                  stream>>>(static_cast<const T*>(out),
                                            static_cast<const T*>(dout), delta,
                                            rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t bhq = static_cast<int64_t>(B) * Hq, bhk = static_cast<int64_t>(B) * Hkv;
  TMaps<DK> mq, mk;
  TMaps<DV> mv, mdo;
  if (!make_map<DK>(&mq, q, bhq, Tq, Ckv::BQ) ||
      !make_map<DV>(&mdo, dout, bhq, Tq, Ckv::BQ) ||
      !make_map<DK>(&mk, k, bhk, mask.S, Ckv::BN) ||
      !make_map<DV>(&mv, v, bhk, mask.S, Ckv::BN))
    return cudaErrorInvalidValue;
  static std::atomic<uint64_t> dkdv_smem_set{0}, dq_smem_set{0};
  err = allow_smem(flash_bwd_dkdv_tc_kernel<DK, DV>, Ckv::SMEM, &dkdv_smem_set);
  if (err != cudaSuccess) return err;
  const dim3 gkv(cdiv(mask.S, Ckv::BN), B * Hkv);
  flash_bwd_dkdv_tc_kernel<DK, DV><<<gkv, kBlock, Ckv::SMEM, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Hq, Hkv, Tq, mask, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the dq kernel's boxes: 64 keys, as the dK/dV kernel's; 64 q rows, which
  // differ from its q tile where that is 32 rows
  static_assert(Cq::BK == Ckv::BN, "the K/V maps serve both kernels");
  if constexpr (Cq::BM != Ckv::BQ) {
    if (!make_map<DK>(&mq, q, bhq, Tq, Cq::BM) ||
        !make_map<DV>(&mdo, dout, bhq, Tq, Cq::BM))
      return cudaErrorInvalidValue;
  }
  err = allow_smem(flash_bwd_dq_tc_kernel<DK, DV>, Cq::SMEM, &dq_smem_set);
  if (err != cudaSuccess) return err;
  const dim3 gq(cdiv(Tq, Cq::BM), B * Hq);
  flash_bwd_dq_tc_kernel<DK, DV><<<gq, kBlock, Cq::SMEM, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<T*>(dq), Hq, Hkv, Tq, mask,
      sm_scale);
  return cudaGetLastError();
}

// The tile plan of the kernels above at head dims (DK, DV), on the host: for each
// q block i of the forward and dQ kernels, kv[2i], kv[2i + 1] = [lo, hi) of
// its kv tiles and kv_full[i * n_kv + t] = 1 where kv tile t takes no
// element mask; for each key block j of the dK/dV kernel, qt[2j],
// qt[2j + 1] = [lo, hi) of its q tiles and q_full[j * n_qt + t] likewise
// (n_kv = cdiv(S, 64), n_qt = cdiv(Tq, bq)).  Returns bq, the dK/dV
// kernel's q rows per tile, and writes nothing where kv is null.
template <int DK, int DV>
int tile_plan(int Tq, const Mask& mask, int* kv, unsigned char* kv_full,
              int* qt, unsigned char* q_full) {
  using F = Fwd<DK, DV>;
  using Cq = Dq<DK, DV>;
  static_assert(F::BM == Cq::BM && F::BK == Cq::BK,
                "the forward and dQ kernels share their tiles");
  constexpr int BM = F::BM, BK = F::BK;
  constexpr int BN = Dkv<DK, DV>::BN, BQ = Dkv<DK, DV>::BQ;
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

// The (d, dv) pairs the kernels are compiled for: the q/k width and the v
// width.  kernels/flash_attention.py's SHAPES lists the same pairs.
#define FA_SHAPES(X) \
  X(16, 16) X(32, 32) X(48, 32) X(64, 64) X(80, 80) X(128, 128) X(192, 128)

// dtype 0 (f32) runs the SIMT kernels, dtype 1 (bf16) the tensor-core ones;
// CALL names the pair as DK, DV
#define FA_CASE_F32(PK, PV) \
  if (D == PK && DVW == PV) { constexpr int DK = PK, DV = PV; return CALL_F32; }
#define FA_CASE_BF16(PK, PV) \
  if (D == PK && DVW == PV) { constexpr int DK = PK, DV = PV; return CALL_BF16; }

}  // namespace

// dtype codes: 0 = f32, 1 = bf16; (D, DVW) one of FA_SHAPES.  Tensors are
// contiguous [B, H, T|S, width]; bf16 ones 16-byte aligned (TMA).  Returns
// the cudaError_t of the launches (0 on success; cudaErrorInvalidValue for
// a pair not compiled); shapes are checked by the caller.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, float* lse, int B,
    int Hq, int Hkv, int Tq, int S, int D, int DVW, int causal, int window,
    int q_offset, float sm_scale, int dtype, void* stream) {
  if (B * Hq == 0 || Tq == 0) return 0;
  if (Hkv < 1 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const Mask mask{S, causal, window, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL_F32 \
  static_cast<int>(fwd<float, DK, DV>(q, k, v, out, lse, B, Hq, Hkv, Tq, mask, sm_scale, s))
#define CALL_BF16 \
  static_cast<int>(tc::fwd<DK, DV>(q, k, v, out, lse, B, Hq, Hkv, Tq, mask, sm_scale, s))
  if (dtype == 0) { FA_SHAPES(FA_CASE_F32) }
  if (dtype == 1) { FA_SHAPES(FA_CASE_BF16) }
#undef CALL_F32
#undef CALL_BF16
  return static_cast<int>(cudaErrorInvalidValue);
}

// delta is f32 scratch [B, Hq, T]; dq is [B, Hq, T, D], dk [B, Hkv, S, D],
// dv [B, Hkv, S, DVW].
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int Tq, int S, int D, int DVW,
    int causal, int window, int q_offset, float sm_scale, int dtype,
    void* stream) {
  if (B * Hq == 0) return 0;
  if (Hkv < 1 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tq == 0) {  // no query: dk = dv = 0
    const size_t n = static_cast<size_t>(B) * Hkv * S * (dtype ? 2 : 4);
    cudaError_t err = cudaMemsetAsync(dk, 0, n * D, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, n * DVW, s);
    return static_cast<int>(err);
  }
  const Mask mask{S, causal, window, q_offset};
#define CALL_F32                                                             \
  static_cast<int>(bwd<float, DK, DV>(q, k, v, out, dout, lse, delta, dq, dk, \
                                      dv, B, Hq, Hkv, Tq, mask, sm_scale, s))
#define CALL_BF16                                                            \
  static_cast<int>(tc::bwd<DK, DV>(q, k, v, out, dout, lse, delta, dq, dk,   \
                                   dv, B, Hq, Hkv, Tq, mask, sm_scale, s))
  if (dtype == 0) { FA_SHAPES(FA_CASE_F32) }
  if (dtype == 1) { FA_SHAPES(FA_CASE_BF16) }
#undef CALL_F32
#undef CALL_BF16
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 kernels' tile plan (tc::tile_plan), computed on the host by the
// Mask functions the kernels run; chip_smoke.py holds it against the
// element mask.  Returns -1 for a pair the kernels do not take.
extern "C" int flash_attention_tile_plan(int Tq, int S, int D, int DVW,
                                         int causal, int window, int q_offset,
                                         int* kv, unsigned char* kv_full,
                                         int* qt, unsigned char* q_full) {
  const Mask mask{S, causal, window, q_offset};
#define CALL_BF16 tc::tile_plan<DK, DV>(Tq, mask, kv, kv_full, qt, q_full)
  FA_SHAPES(FA_CASE_BF16)
#undef CALL_BF16
  return -1;
}
