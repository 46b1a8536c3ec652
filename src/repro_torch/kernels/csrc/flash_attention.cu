// GQA flash attention for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel).  The forward computes the same
// function:
//
//   s_ij  = (q_i * sm_scale) . k_j                       f32
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
//   dk_j  = sum_i ds_ij (q_i * sm_scale)
//   dq_i  = sm_scale * sum_j ds_ij k_j
//
// What bounds it on this card: operations.  At the training shape (B 2,
// Hq 32, T = S = 2048, d 64, causal) the forward does ~34 GFLOP on ~40 MB,
// far above the ~295 flop/byte where bf16 tensor cores stop being the
// limit; this kernel uses the f32 SIMT units (67 TFLOP/s), not the tensor
// cores, so it sits well above the tensor-core bound.
//
// Design.  The TPU kernel walks a (b*h, q-block, kv-block) grid with the kv
// axis sequential and carries (m, l, acc) in VMEM scratch; blocks here run
// in parallel and in no order, so:
//   * forward: one thread block per (b*hq, q-block) loops over its kv tiles
//     itself.  Each q row belongs to TPR adjacent threads (TPR = d / 64 for
//     d = 128, else 1), each holding its slice of q and acc in registers;
//     the row's scores over a 32-key tile stay in registers, partial dot
//     products meet through warp shuffles (a butterfly of adds, so every
//     thread of a row holds the same bits).  K and V tiles are staged in
//     shared memory as f32 and read as 16-byte broadcasts.
//   * kv tiles that no row of the block can see (causal future, left of the
//     window, past S) are skipped: a fully masked tile leaves (m, l, acc)
//     unchanged, so skipping is exact.
//   * backward, deterministic, no floating-point atomics:
//       - one launch per (b*hkv, kv-block): each thread owns one key (split
//         over TPR = d / 32 threads) and accumulates dk and dv in registers
//         over the q tiles of all Hq/Hkv heads of its group, in a fixed
//         order;
//       - one launch per (b*hq, q-block): each thread owns one q row and
//         accumulates dq over the kv tiles in order.
//     D = rowsum(dout * out) is computed by a preprocess kernel into f32
//     scratch first.
//   * inputs are f32 or bf16, converted to f32 on load; every score,
//     probability and accumulator is f32; outputs are in the input dtype
//     (bf16 by round-to-nearest-even).
// It uses no tensor cores, TMA or wgmma: a simple kernel that is right.
// Built without fast math: expf and logf are the accurate ones.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Mask {
  int S, causal, window, q_offset;
  __device__ __forceinline__ bool visible(int qpos, int kpos) const {
    bool ok = kpos < S;
    if (causal) ok = ok && kpos <= qpos;
    if (window) ok = ok && kpos > qpos - window;
    return ok;
  }
  // [lo, hi) tiles of `tile` keys holding a key visible to some q position
  // in [q_first, q_last]
  __device__ __forceinline__ void kv_tiles(int q_first, int q_last, int tile,
                                           int* lo, int* hi) const {
    int k_max = S - 1;
    if (causal) k_max = min(k_max, q_last);
    int k_min = 0;
    if (window) k_min = max(0, q_first - window + 1);
    if (k_max < k_min) {
      *lo = 0;
      *hi = 0;
      return;
    }
    *lo = k_min / tile;
    *hi = k_max / tile + 1;
  }
  // [lo, hi) q rows (of T) that see some key in [k_first, k_last]
  __device__ __forceinline__ void q_rows(int k_first, int k_last, int T,
                                         int* lo, int* hi) const {
    int a = causal ? max(0, k_first - q_offset) : 0;
    int b = window ? min(T, k_last + window - q_offset) : T;
    *lo = a;
    *hi = b > a ? b : a;
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

#define FA_DISPATCH(DTYPE, D, CALL)                                         \
  do {                                                                      \
    if (DTYPE == 0) {                                                       \
      using T = float;                                                      \
      switch (D) {                                                          \
        case 16: { constexpr int HD = 16; return CALL; }                    \
        case 32: { constexpr int HD = 32; return CALL; }                    \
        case 64: { constexpr int HD = 64; return CALL; }                    \
        case 128: { constexpr int HD = 128; return CALL; }                  \
      }                                                                     \
    } else if (DTYPE == 1) {                                                \
      using T = __nv_bfloat16;                                              \
      switch (D) {                                                          \
        case 16: { constexpr int HD = 16; return CALL; }                    \
        case 32: { constexpr int HD = 32; return CALL; }                    \
        case 64: { constexpr int HD = 64; return CALL; }                    \
        case 128: { constexpr int HD = 128; return CALL; }                  \
      }                                                                     \
    }                                                                       \
    return static_cast<int>(cudaErrorInvalidValue);                         \
  } while (0)

}  // namespace

// dtype codes: 0 = f32, 1 = bf16; head dims 16, 32, 64, 128.  Tensors are
// contiguous [B, H, T|S, D].  Returns the cudaError_t of the launches (0 on
// success); shapes are checked by the caller.
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
                                           sm_scale, s))));
}
