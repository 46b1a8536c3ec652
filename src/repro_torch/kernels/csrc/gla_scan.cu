// Chunked gated-linear-attention scan (mLSTM / SSD) for Hopper (sm_90a):
// forward and backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py (gla_scan,
// body _gla_kernel).  Per batch*head, in chunks of L <= 128 steps, with
// q scaled by dk^-0.5 in f32, v^ = [v | 1] (dv + 1 columns, the last one
// carrying the normalizer) and b_t the within-chunk cumulative sum of
// log_f (steps past T: log_f = 0, i = 0, q = k = v = 0):
//
//   S_ts   = q_t . k_s                            (s <= t, else 0)
//   A_ts   = S_ts exp(b_t - b_s) i_s              (selected, never a 0/1
//                                                  mask times an exp)
//   num_t  = sum_s A_ts v^_s + exp(b_t) q_t C      C: state entering the chunk
//   C'     = exp(b_L) C + sum_s exp(b_L - b_s) i_s k_s v^_s^T
//   out_t  = num_t[:dv] / max(|num_t[dv]|, 1)      (normalize; else num_t[:dv])
//
// The reference has no backward kernel (it differentiates its XLA twin);
// the backward here is the gradient of the same function, walking the
// chunks in reverse with dC (the gradient of the state leaving the chunk):
//
//   dN_t   = [dout_t / den_t | g_t],  g_t = -sign(n_t) [|n_t| > 1]
//            sum_j dout_tj out_tj / den_t         (prep kernel)
//   dv^_s  = sum_t A_ts dN_t + w_s dC^T k_s       w_s = exp(b_L - b_s) i_s
//   dA_ts  = dN_t . v^_s;  dS = dA exp(b_t - b_s) i_s;  E = dA S exp(b_t - b_s)
//   dq_t   = sum_s dS_ts k_s + exp(b_t) C dN_t
//   dk_s   = sum_t dS_ts q_t + w_s dC v^_s
//   db_t   = sum_s E_ts i_s - i_t sum_u E_ut + exp(b_t) q_t . C dN_t - dw_t w_t
//            (+ at t = L-1: exp(b_L) <dC, C> + sum_s dw_s w_s),
//            dw_s = k_s . dC v^_s
//   di_s   = sum_t E_ts + dw_s exp(b_L - b_s);   dlog_f = reverse cumsum of db
//   dC    <- exp(b_L) dC + sum_t exp(b_t) q_t dN_t^T
//
// What bounds it on this card: bytes, at xlstm-125m's training shape (B 4,
// H 4, T 2048, dk = dv = 384, bf16): q, k, v and out are 100 MB against
// ~26 GFLOP, 0.03 ms at 3.35 TB/s.  These kernels use the f32 SIMT units
// and recompute, so they sit far above that.
//
// Design.  The TPU kernel walks a (b*h, chunk) grid with the chunk axis
// sequential and keeps the whole [dk, dv+1] f32 state in VMEM: 591 KB at
// dk = dv = 384, against 227 KB of shared memory a block here.  So:
//   * the scores S of every chunk are independent of the state: one block
//     per (chunk, b*h) computes them first into an f32 buffer (a register
//     tile of 8 x 8 per thread over dk slices of 16 staged in shared memory);
//   * the scan: one block per (value tile of 32 columns, b*h) walks the
//     chunks in order, carrying its own [dk, 32] slice of the state plus its
//     own copy of the normalizer column in shared memory, so every tile can
//     divide its outputs without talking to the others.  q and k of a chunk
//     are staged through shared memory in slices of 16 of dk;
//   * the backward: the same tiling in reverse.  dv is tile-local; dq, dk and
//     the gate gradients are sums over all value columns, so each tile writes
//     f32 partials (tile 0 also carries the normalizer column) and a reduce
//     kernel adds them in tile order: deterministic, no atomics.  The forward
//     saves the state entering every chunk and the normalizer of every step
//     when a gradient is wanted; the backward recomputes the scores.
//   * inputs are f32 or bf16, converted on load; everything else is f32;
//     outputs are in the input dtype (bf16 by round-to-nearest-even).
// It uses no tensor cores, TMA or wgmma: a simple kernel that is right.
// Built without fast math: expf is the accurate one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;          // value columns per block
constexpr int kCols = kTile + 1;   // + the normalizer column
constexpr int kSlice = 16;         // dk slice staged in shared memory
constexpr int kSl = kSlice + 1;    // padded slice row
constexpr int kWide = 32;          // dk rows of a state-update slice
constexpr int kMaxL = 128;
constexpr int kMaxDk = 384;
constexpr int kHalfCols = 17;      // columns a thread owns: jh + 2m
// the thread maps below: (row, column half) over 128 rows; (row, column
// quarter) over a kWide slice; (row, column pair) over a kSlice slice
static_assert(kThreads == 2 * kMaxL && kThreads == 8 * kWide &&
                  kThreads == 16 * kSlice && kTile == 32,
              "thread maps assume 256 threads and 32-column tiles");

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

struct Dims {
  int BH, T, dk, dv, L, nc, normalize;
  float scale;
};

// ---------------------------------------------------------------------------
// scores: S[bh, c, t, s] = (q_t * scale) . k_s for s <= t, else 0
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
gla_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  float* __restrict__ S, Dims d) {
  __shared__ float qs[kMaxL * kSl];
  __shared__ float ks[kMaxL * kSl];
  const int c = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16, L = d.L;
  const long long base = static_cast<long long>(bh) * d.T;
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  for (int i0 = 0; i0 < d.dk; i0 += kSlice) {
    for (int e = tid; e < L * kSlice; e += kThreads) {
      const int r = e / kSlice, col = e % kSlice, pos = c * L + r;
      float qv = 0.f, kv = 0.f;
      if (pos < d.T) {
        const long long off = (base + pos) * d.dk + i0 + col;
        qv = to_f32(q[off]) * d.scale;
        kv = to_f32(k[off]);
      }
      qs[r * kSl + col] = qv;
      ks[r * kSl + col] = kv;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kSlice; ++kk) {
      float qa[8], kb[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int t = ty + 16 * a;
        qa[a] = t < L ? qs[t * kSl + kk] : 0.f;
      }
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int s = tx + 16 * b;
        kb[b] = s < L ? ks[s * kSl + kk] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] += qa[a] * kb[b];
    }
    __syncthreads();
  }
  float* out = S + (static_cast<long long>(bh) * d.nc + c) * L * L;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int t = ty + 16 * a, s = tx + 16 * b;
      if (t < L && s < L) out[t * L + s] = s <= t ? acc[a][b] : 0.f;
    }
}

// the chunk's gates into shared memory: b (cumsum of log_f), exp(b), i,
// w = exp(b_L - b) i; padded steps get log_f = 0 and i = 0.  Ends synced.
__device__ void load_gates(const float* __restrict__ lf,
                           const float* __restrict__ ig, int bh, int c,
                           const Dims& d, float* b, float* eb, float* igs,
                           float* w) {
  const int tid = threadIdx.x, L = d.L;
  if (tid < L) {
    const int pos = c * L + tid;
    const long long off = static_cast<long long>(bh) * d.T + pos;
    b[tid] = pos < d.T ? lf[off] : 0.f;
    igs[tid] = pos < d.T ? ig[off] : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int t = 0; t < L; ++t) {
      run += b[t];
      b[t] = run;
    }
  }
  __syncthreads();
  if (tid < L) {
    eb[tid] = expf(b[tid]);
    w[tid] = expf(b[L - 1] - b[tid]) * igs[tid];
  }
  __syncthreads();
}

// v^ tile [L][kCols]: this tile's value columns, zeros past dv, 1 in the
// normalizer column
template <typename T>
__device__ void load_vhat(const T* __restrict__ v, int bh, int c, int j0,
                          int ncols, const Dims& d, float* vh) {
  const int L = d.L;
  for (int e = threadIdx.x; e < L * kCols; e += kThreads) {
    const int t = e / kCols, j = e % kCols, pos = c * L + t;
    float val = 0.f;
    if (j == kTile)
      val = 1.f;
    else if (j < ncols && pos < d.T)
      val = to_f32(v[(static_cast<long long>(bh) * d.T + pos) * d.dv + j0 + j]);
    vh[t * kCols + j] = val;
  }
}

// a dk slice [L][kSl] of q (scaled) or k, zeros past T
template <typename T>
__device__ void load_slice(const T* __restrict__ x, int bh, int c, int i0,
                           float mul, const Dims& d, float* sl) {
  const int L = d.L;
  for (int e = threadIdx.x; e < L * kSlice; e += kThreads) {
    const int r = e / kSlice, col = e % kSlice, pos = c * L + r;
    float val = 0.f;
    if (pos < d.T)
      val = to_f32(x[(static_cast<long long>(bh) * d.T + pos) * d.dk + i0 + col]) * mul;
    sl[r * kSl + col] = val;
  }
}

// the scores tile [L][L+1], also the k*w slice [L][kCols] of the state
// update
__host__ __device__ inline int a_floats(int L) {
  return L * (L + 1 > kCols ? L + 1 : kCols);
}

__host__ __device__ inline int fwd_smem_floats(int dk, int L) {
  return dk * kCols + a_floats(L) + L * kCols + L * kSl + 5 * L;
}

__host__ __device__ inline int bwd_smem_floats(int dk, int L) {
  return dk * kCols + L * (L + 1) + 2 * L * kCols + 2 * L * kSl +
         kSlice * kCols + 5 * L + 3 * L + 16 * L + 4 * L + kThreads;
}

// ---------------------------------------------------------------------------
// forward scan: one block per (value tile, b*h)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gla_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ lf,
               const float* __restrict__ ig, const float* __restrict__ S,
               T* __restrict__ out, float* __restrict__ state,
               float* __restrict__ states, float* __restrict__ norms, Dims d) {
  extern __shared__ float sm[];
  const int L = d.L, lda = L + 1, dk = d.dk;
  float* C = sm;                     // [dk][kCols]
  float* A = C + dk * kCols;         // [L][lda]
  float* vh = A + a_floats(L);       // [L][kCols]
  float* sl = vh + L * kCols;        // [L][kSl]
  float* b = sl + L * kSl;
  float* eb = b + L;
  float* igs = eb + L;
  float* w = igs + L;
  float* nrm = w + L;

  const int tile = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int j0 = tile * kTile, ncols = min(kTile, d.dv - j0);
  const int r = tid & 127, jh = tid >> 7;
  const long long sbase = static_cast<long long>(bh) * d.nc;
  for (int e = tid; e < dk * kCols; e += kThreads) C[e] = 0.f;

  for (int c = 0; c < d.nc; ++c) {
    __syncthreads();
    if (states) {  // the state entering this chunk, for the backward
      float* dst = states + (sbase + c) * dk * (d.dv + 1);
      for (int e = tid; e < dk * kCols; e += kThreads) {
        const int i = e / kCols, j = e % kCols;
        if (j < ncols)
          dst[static_cast<long long>(i) * (d.dv + 1) + j0 + j] = C[e];
        else if (j == kTile && tile == 0)
          dst[static_cast<long long>(i) * (d.dv + 1) + d.dv] = C[e];
      }
    }
    load_gates(lf, ig, bh, c, d, b, eb, igs, w);
    const float* Sc = S + (sbase + c) * L * L;
    for (int e = tid; e < L * L; e += kThreads) {
      const int t = e / L, s = e % L;
      A[t * lda + s] = s <= t ? Sc[e] * expf(b[t] - b[s]) * igs[s] : 0.f;
    }
    load_vhat(v, bh, c, j0, ncols, d, vh);

    // inter-chunk: q_t C, over dk slices
    float acc[kHalfCols];
#pragma unroll
    for (int m = 0; m < kHalfCols; ++m) acc[m] = 0.f;
    for (int i0 = 0; i0 < dk; i0 += kSlice) {
      __syncthreads();
      load_slice(q, bh, c, i0, d.scale, d, sl);
      __syncthreads();
      if (r < L) {
        for (int kk = 0; kk < kSlice; ++kk) {
          const float qv = sl[r * kSl + kk];
          const float* Crow = C + (i0 + kk) * kCols + jh;
#pragma unroll
          for (int m = 0; m < kHalfCols; ++m)
            if (jh + 2 * m < kCols) acc[m] += qv * Crow[2 * m];
        }
      }
    }
    // intra-chunk: sum_s A_ts v^_s
    if (r < L) {
      const float e_b = eb[r];
#pragma unroll
      for (int m = 0; m < kHalfCols; ++m) acc[m] *= e_b;
      for (int s = 0; s <= r; ++s) {
        const float a = A[r * lda + s];
        const float* vrow = vh + s * kCols + jh;
#pragma unroll
        for (int m = 0; m < kHalfCols; ++m)
          if (jh + 2 * m < kCols) acc[m] += a * vrow[2 * m];
      }
      if (jh == 0) nrm[r] = acc[kHalfCols - 1];  // column 32
    }
    __syncthreads();
    const int pos = c * L + r;
    if (r < L && pos < d.T) {
      const float den = d.normalize ? fmaxf(fabsf(nrm[r]), 1.f) : 1.f;
      T* orow = out + (static_cast<long long>(bh) * d.T + pos) * d.dv + j0;
#pragma unroll
      for (int m = 0; m < kHalfCols; ++m) {
        const int j = jh + 2 * m;
        if (j < ncols)
          orow[j] = from_f32<T>(d.normalize ? acc[m] / den : acc[m]);
      }
      if (norms && tile == 0 && jh == 0)
        norms[static_cast<long long>(bh) * d.T + pos] = nrm[r];
    }
    // state update: C = exp(b_L) C + sum_s (k_s w_s) v^_s^T, over dk slices
    // of 32 rows staged as k*w in the A buffer (free until the next
    // chunk); thread (row kk, column quarter jq) owns columns jq + 8m and,
    // for jq = 0, the normalizer column
    const float ebL = expf(b[L - 1]);
    float* kw = A;  // [L][kCols]
    for (int i0 = 0; i0 < dk; i0 += kWide) {
      __syncthreads();
      for (int e = tid; e < L * kWide; e += kThreads) {
        const int s = e / kWide, kk = e % kWide, pos = c * L + s;
        float val = 0.f;
        if (pos < d.T && i0 + kk < dk)
          val = to_f32(k[(static_cast<long long>(bh) * d.T + pos) * dk + i0 + kk]) * w[s];
        kw[s * kCols + kk] = val;
      }
      __syncthreads();
      const int kk = tid >> 3, jq = tid & 7;
      if (i0 + kk < dk) {
        float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
        for (int s = 0; s < L; ++s) {
          const float kv = kw[s * kCols + kk];
          const float* vrow = vh + s * kCols + jq;
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[m] += kv * vrow[8 * m];
          if (jq == 0) acc[4] += kv * vrow[kTile];
        }
        float* crow = C + (i0 + kk) * kCols + jq;
#pragma unroll
        for (int m = 0; m < 4; ++m) crow[8 * m] = ebL * crow[8 * m] + acc[m];
        if (jq == 0) crow[kTile] = ebL * crow[kTile] + acc[4];
      }
    }
  }
  __syncthreads();
  float* dst = state + static_cast<long long>(bh) * dk * (d.dv + 1);
  for (int e = tid; e < dk * kCols; e += kThreads) {
    const int i = e / kCols, j = e % kCols;
    if (j < ncols)
      dst[static_cast<long long>(i) * (d.dv + 1) + j0 + j] = C[e];
    else if (j == kTile && tile == 0)
      dst[static_cast<long long>(i) * (d.dv + 1) + d.dv] = C[e];
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// g_t, the gradient reaching the normalizer column: one warp per step
template <typename T>
__global__ void __launch_bounds__(kThreads)
gla_bwd_prep_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                    const float* __restrict__ norms, float* __restrict__ g,
                    long long rows, int dv, int normalize) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float sum = 0.f;
  for (int j = lane; j < dv; j += 32)
    sum += to_f32(dout[row * dv + j]) * to_f32(out[row * dv + j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) {
    const float n = norms[row];
    float gv = 0.f;
    if (normalize && fabsf(n) > 1.f) gv = (n > 0.f ? -sum : sum) / fabsf(n);
    g[row] = gv;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gla_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ lf,
               const float* __restrict__ ig, const T* __restrict__ dout,
               const float* __restrict__ states,
               const float* __restrict__ norms, const float* __restrict__ S,
               const float* __restrict__ g, float* __restrict__ dq_part,
               float* __restrict__ dk_part, float* __restrict__ dlf_part,
               float* __restrict__ dig_part, T* __restrict__ dv_out, Dims d) {
  extern __shared__ float sm[];
  const int L = d.L, lda = L + 1, dk = d.dk;
  float* dC = sm;                      // [dk][kCols]
  float* Ss = dC + dk * kCols;         // [L][lda]: S, then dS
  float* dN = Ss + L * lda;            // [L][kCols]
  float* vh = dN + L * kCols;          // [L][kCols]
  float* qsl = vh + L * kCols;         // [L][kSl]
  float* ksl = qsl + L * kSl;          // [L][kSl]
  float* Csl = ksl + L * kSl;          // [kSlice][kCols]
  float* b = Csl + kSlice * kCols;
  float* eb = b + L;
  float* igs = eb + L;
  float* w = igs + L;
  float* den = w + L;
  float* rowE = den + L;
  float* colE = rowE + L;
  float* dbt = colE + L;
  float* colpart = dbt + L;            // [16][L]
  float* dbi = colpart + 16 * L;       // [2][L]
  float* dws = dbi + 2 * L;            // [2][L]
  float* red = dws + 2 * L;            // [kThreads]

  const int tile = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int j0 = tile * kTile, ncols = min(kTile, d.dv - j0);
  const int r = tid & 127, jh = tid >> 7, half = tid >> 7;
  const int ty = tid / 16, tx = tid % 16;
  const long long base = static_cast<long long>(bh) * d.T;
  const long long sbase = static_cast<long long>(bh) * d.nc;
  for (int e = tid; e < dk * kCols; e += kThreads) dC[e] = 0.f;

  for (int c = d.nc - 1; c >= 0; --c) {
    __syncthreads();
    load_gates(lf, ig, bh, c, d, b, eb, igs, w);
    if (tid < L) {
      const int pos = c * L + tid;
      den[tid] = (d.normalize && pos < d.T)
                     ? fmaxf(fabsf(norms[base + pos]), 1.f) : 1.f;
    }
    __syncthreads();
    const float* Sc = S + (sbase + c) * L * L;
    for (int e = tid; e < L * L; e += kThreads)
      Ss[(e / L) * lda + e % L] = Sc[e];
    for (int e = tid; e < L * kCols; e += kThreads) {
      const int t = e / kCols, j = e % kCols, pos = c * L + t;
      float val = 0.f;
      if (pos < d.T) {
        if (j < ncols)
          val = to_f32(dout[(base + pos) * d.dv + j0 + j]) / den[t];
        else if (j == kTile && tile == 0)
          val = g[base + pos];
      }
      dN[e] = val;
    }
    load_vhat(v, bh, c, j0, ncols, d, vh);
    __syncthreads();

    // dv^_s = sum_t A_ts dN_t (+ w_s dC^T k_s below)
    float dva[kHalfCols];
#pragma unroll
    for (int m = 0; m < kHalfCols; ++m) dva[m] = 0.f;
    if (r < L) {
      const float bs = b[r], is = igs[r];
      for (int t = r; t < L; ++t) {
        const float a = Ss[t * lda + r] * expf(b[t] - bs) * is;
        const float* nrow = dN + t * kCols + jh;
#pragma unroll
        for (int m = 0; m < kHalfCols; ++m)
          if (jh + 2 * m < kCols) dva[m] += a * nrow[2 * m];
      }
    }
    __syncthreads();

    // dA = dN v^T on an 8 x 8 register tile; dS, E, and E's row/col sums
    {
      float acc[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int bb = 0; bb < 8; ++bb) acc[a][bb] = 0.f;
      for (int j = 0; j < kCols; ++j) {
        float na[8], vb[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int t = ty + 16 * a;
          na[a] = t < L ? dN[t * kCols + j] : 0.f;
        }
#pragma unroll
        for (int bb = 0; bb < 8; ++bb) {
          const int s = tx + 16 * bb;
          vb[bb] = s < L ? vh[s * kCols + j] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int bb = 0; bb < 8; ++bb) acc[a][bb] += na[a] * vb[bb];
      }
      float rows[8], cols[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) rows[a] = cols[a] = 0.f;
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int bb = 0; bb < 8; ++bb) {
          const int t = ty + 16 * a, s = tx + 16 * bb;
          if (t < L && s < L) {
            float dS = 0.f;
            if (s <= t) {
              const float ex = expf(b[t] - b[s]);
              const float E = acc[a][bb] * Ss[t * lda + s] * ex;
              dS = acc[a][bb] * ex * igs[s];
              rows[a] += E * igs[s];
              cols[bb] += E;
            }
            Ss[t * lda + s] = dS;
          }
        }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        float x = rows[a];
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
        const int t = ty + 16 * a;
        if (tx == 0 && t < L) rowE[t] = x;
      }
#pragma unroll
      for (int bb = 0; bb < 8; ++bb) {
        const int s = tx + 16 * bb;
        if (s < L) colpart[ty * L + s] = cols[bb];
      }
    }
    __syncthreads();
    if (tid < L) {
      float x = 0.f;
      for (int y = 0; y < 16; ++y) x += colpart[y * L + tid];
      colE[tid] = x;
    }

    // over dk slices: dq, dk partials, dw, the inter term of db, <dC, C>,
    // the dC^T k term of dv, then the dC update
    float dbi_acc = 0.f, dw_acc = 0.f, dbl_acc = 0.f;
    const float ebL = expf(b[L - 1]);
    const float* Cst = states + (sbase + c) * dk * (d.dv + 1);
    for (int i0 = 0; i0 < dk; i0 += kSlice) {
      __syncthreads();
      load_slice(q, bh, c, i0, d.scale, d, qsl);
      load_slice(k, bh, c, i0, 1.f, d, ksl);
      for (int e = tid; e < kSlice * kCols; e += kThreads) {
        const int kk = e / kCols, j = e % kCols;
        const long long row = static_cast<long long>(i0 + kk) * (d.dv + 1);
        float val = 0.f;
        if (j < ncols)
          val = Cst[row + j0 + j];
        else if (j == kTile && tile == 0)
          val = Cst[row + d.dv];
        Csl[e] = val;
      }
      __syncthreads();
      const int pos = c * L + r;
      if (r < L) {
        // thread (r, half) owns dq_r and dk_r over kk in [k0, k0 + 8)
        const int k0 = half * 8;
        float dqv[8], dkv[8], rv[8], u[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) dqv[m] = dkv[m] = rv[m] = u[m] = 0.f;
        for (int s = 0; s <= r; ++s) {  // dq_t = sum_s dS_ts k_s (t = r)
          const float ds = Ss[r * lda + s];
          const float* krow = ksl + s * kSl + k0;
#pragma unroll
          for (int m = 0; m < 8; ++m) dqv[m] += ds * krow[m];
        }
        for (int t = r; t < L; ++t) {  // dk_s = sum_t dS_ts q_t (s = r)
          const float ds = Ss[t * lda + r];
          const float* qrow = qsl + t * kSl + k0;
#pragma unroll
          for (int m = 0; m < 8; ++m) dkv[m] += ds * qrow[m];
        }
        for (int j = 0; j < kCols; ++j) {  // C dN_r and dC v^_r
          const float nv = dN[r * kCols + j], vv = vh[r * kCols + j];
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            rv[m] += Csl[(k0 + m) * kCols + j] * nv;
            u[m] += dC[(i0 + k0 + m) * kCols + j] * vv;
          }
        }
        const long long prow =
            ((static_cast<long long>(tile) * d.BH + bh) * d.T + pos) * dk + i0 + k0;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          dqv[m] += eb[r] * rv[m];
          dbi_acc += qsl[r * kSl + k0 + m] * rv[m];
          dkv[m] += w[r] * u[m];
          dw_acc += ksl[r * kSl + k0 + m] * u[m];
          if (pos < d.T) {
            dq_part[prow + m] = dqv[m];
            dk_part[prow + m] = dkv[m];
          }
        }
        // dv^_s += w_s sum_kk k_s[kk] dC[kk][:]
        float x[kHalfCols];
#pragma unroll
        for (int m = 0; m < kHalfCols; ++m) x[m] = 0.f;
        for (int kk = 0; kk < kSlice; ++kk) {
          const float kv = ksl[r * kSl + kk];
          const float* crow = dC + (i0 + kk) * kCols + jh;
#pragma unroll
          for (int m = 0; m < kHalfCols; ++m)
            if (jh + 2 * m < kCols) x[m] += kv * crow[2 * m];
        }
        const float ws = w[r];
#pragma unroll
        for (int m = 0; m < kHalfCols; ++m) dva[m] += ws * x[m];
      }
      for (int e = tid; e < kSlice * kCols; e += kThreads)
        dbl_acc += dC[i0 * kCols + e] * Csl[e];
      __syncthreads();
      {  // dC rows of the slice: thread (kk, jj) owns columns jj, jj + 16
        // and, for jj = 0, the normalizer column
        const int kk = tid >> 4, jj = tid & 15;
        float x0 = 0.f, x1 = 0.f, x2 = 0.f;
        for (int t = 0; t < L; ++t) {
          const float qe = qsl[t * kSl + kk] * eb[t];
          const float* nrow = dN + t * kCols;
          x0 += qe * nrow[jj];
          x1 += qe * nrow[jj + 16];
          if (jj == 0) x2 += qe * nrow[kTile];
        }
        float* p = dC + (i0 + kk) * kCols;
        p[jj] = ebL * p[jj] + x0;
        p[jj + 16] = ebL * p[jj + 16] + x1;
        if (jj == 0) p[kTile] = ebL * p[kTile] + x2;
      }
    }
    // gate gradients of the chunk
    if (r < L) {
      dbi[half * L + r] = dbi_acc;
      dws[half * L + r] = dw_acc;
    }
    red[tid] = dbl_acc;
    __syncthreads();
    if (tid < L) {
      const float dw = dws[tid] + dws[L + tid];
      dbt[tid] = rowE[tid] - igs[tid] * colE[tid] +
                 eb[tid] * (dbi[tid] + dbi[L + tid]) - dw * w[tid];
    }
    __syncthreads();
    if (tid == 0) {
      float dbl = 0.f, dww = 0.f;
      for (int i = 0; i < kThreads; ++i) dbl += red[i];
      for (int s = 0; s < L; ++s) dww += (dws[s] + dws[L + s]) * w[s];
      dbt[L - 1] += ebL * dbl + dww;
      float run = 0.f;
      for (int t = L - 1; t >= 0; --t) {
        run += dbt[t];
        dbt[t] = run;  // now dlog_f
      }
    }
    __syncthreads();
    const int pos = c * L + r;
    if (r < L && pos < d.T) {
      if (half == 0) {
        const long long goff = (static_cast<long long>(tile) * d.BH + bh) * d.T + pos;
        const float dw = dws[r] + dws[L + r];
        dlf_part[goff] = dbt[r];
        dig_part[goff] = colE[r] + dw * expf(b[L - 1] - b[r]);
      }
      T* drow = dv_out + (base + pos) * d.dv + j0;
#pragma unroll
      for (int m = 0; m < kHalfCols; ++m) {
        const int j = jh + 2 * m;
        if (j < ncols) drow[j] = from_f32<T>(dva[m]);
      }
    }
  }
}

// fixed-order sums of the tiles' partials; dq also takes the q scale
template <typename T>
__global__ void __launch_bounds__(kThreads)
gla_bwd_reduce_kernel(const float* __restrict__ dq_part,
                      const float* __restrict__ dk_part,
                      const float* __restrict__ dlf_part,
                      const float* __restrict__ dig_part, T* __restrict__ dq,
                      T* __restrict__ dk, float* __restrict__ dlf,
                      float* __restrict__ dig, int nt, long long n_qk,
                      long long n_g, float scale) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_qk; i += stride) {
    float a = 0.f, b = 0.f;
    for (int t = 0; t < nt; ++t) {
      a += dq_part[t * n_qk + i];
      b += dk_part[t * n_qk + i];
    }
    dq[i] = from_f32<T>(a * scale);
    dk[i] = from_f32<T>(b);
  }
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_g; i += stride) {
    float a = 0.f, b = 0.f;
    for (int t = 0; t < nt; ++t) {
      a += dlf_part[t * n_g + i];
      b += dig_part[t * n_g + i];
    }
    dlf[i] = a;
    dig[i] = b;
  }
}

bool dims_ok(const Dims& d) {
  return d.BH > 0 && d.T > 0 && d.dk % kSlice == 0 && d.dk >= kSlice &&
         d.dk <= kMaxDk && d.dv % 16 == 0 && d.dv >= 16 && d.L >= 1 &&
         d.L <= kMaxL && d.nc == (d.T + d.L - 1) / d.L;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const float* lf,
               const float* ig, void* out, float* state, float* S,
               float* states, float* norms, Dims d, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  gla_scores_kernel<T><<<dim3(d.nc, d.BH), kThreads, 0, st>>>(qt, kt, S, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * fwd_smem_floats(d.dk, d.L);
  err = cudaFuncSetAttribute(gla_fwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (d.dv + kTile - 1) / kTile;
  gla_fwd_kernel<T><<<dim3(nt, d.BH), kThreads, smem, st>>>(
      qt, kt, static_cast<const T*>(v), lf, ig, S, static_cast<T*>(out),
      state, states, norms, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const float* lf,
               const float* ig, const void* out, const void* dout,
               const float* states, const float* norms, float* S, float* g,
               float* dq_part, float* dk_part, float* dlf_part,
               float* dig_part, void* dq, void* dk, void* dv, float* dlf,
               float* dig, Dims d, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  gla_scores_kernel<T><<<dim3(d.nc, d.BH), kThreads, 0, st>>>(qt, kt, S, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(d.BH) * d.T;
  const long long pgrid = (rows + kThreads / 32 - 1) / (kThreads / 32);
  gla_bwd_prep_kernel<T><<<static_cast<unsigned>(pgrid), kThreads, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), norms, g, rows,
      d.dv, d.normalize);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * bwd_smem_floats(d.dk, d.L);
  err = cudaFuncSetAttribute(gla_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (d.dv + kTile - 1) / kTile;
  gla_bwd_kernel<T><<<dim3(nt, d.BH), kThreads, smem, st>>>(
      qt, kt, static_cast<const T*>(v), lf, ig, static_cast<const T*>(dout),
      states, norms, S, g, dq_part, dk_part, dlf_part, dig_part,
      static_cast<T*>(dv), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_qk = rows * d.dk;
  long long grid = (n_qk + kThreads - 1) / kThreads;
  if (grid > 132 * 16) grid = 132 * 16;
  gla_bwd_reduce_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
      dq_part, dk_part, dlf_part, dig_part, static_cast<T*>(dq),
      static_cast<T*>(dk), dlf, dig, nt, n_qk, rows, d.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v, out).  q, k [BH, T, dk], v and out
// [BH, T, dv], log_f and i_gate [BH, T] f32, state [BH, dk, dv+1] f32,
// scores [BH, nc, L, L] f32 scratch.  states ([BH, nc, dk, dv+1]) and norms
// ([BH, T]) may be null; when given, the forward saves the state entering
// every chunk and every step's normalizer into them.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int gla_scan_fwd_launch(const void* q, const void* k, const void* v,
                                   const float* lf, const float* ig, void* out,
                                   float* state, float* scores, float* states,
                                   float* norms, int BH, int T, int dk, int dv,
                                   int L, int nc, int normalize, float scale,
                                   int dtype, void* stream) {
  const Dims d{BH, T, dk, dv, L, nc, normalize, scale};
  if (!dims_ok(d) || (states == nullptr) != (norms == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (sizeof(float) * fwd_smem_floats(dk, L) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(q, k, v, lf, ig, out, state, scores, states,
                             norms, d, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(q, k, v, lf, ig, out, state, scores,
                                     states, norms, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: dq, dk, dv in the input dtype ([BH, T, d]), dlog_f and
// di_gate f32 [BH, T].  scores, g ([BH, T]) and the partials (dq_part,
// dk_part [n_tiles, BH, T, dk]; dlf_part, dig_part [n_tiles, BH, T], n_tiles
// = ceil(dv / 32)) are f32 scratch.
extern "C" int gla_scan_bwd_launch(
    const void* q, const void* k, const void* v, const float* lf,
    const float* ig, const void* out, const void* dout, const float* states,
    const float* norms, float* scores, float* g, float* dq_part,
    float* dk_part, float* dlf_part, float* dig_part, void* dq, void* dk,
    void* dv, float* dlf, float* dig, int BH, int T, int dk_, int dv_, int L,
    int nc, int normalize, float scale, int dtype, void* stream) {
  const Dims d{BH, T, dk_, dv_, L, nc, normalize, scale};
  if (!dims_ok(d)) return static_cast<int>(cudaErrorInvalidValue);
  if (sizeof(float) * bwd_smem_floats(dk_, L) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, lf, ig, out, dout, states, norms,
                             scores, g, dq_part, dk_part, dlf_part, dig_part,
                             dq, dk, dv, dlf, dig, d, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, lf, ig, out, dout, states,
                                     norms, scores, g, dq_part, dk_part,
                                     dlf_part, dig_part, dq, dk, dv, dlf, dig,
                                     d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
