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
// ~26 GFLOP, 0.03 ms at 3.35 TB/s.  Two routes, chosen by dtype alone:
//
// * bf16 (namespace tc): the tensor cores, every product on wgmma, the
//   chunks in parallel.  The TPU kernel walks a (b*h, chunk) grid with the
//   chunk axis sequential because it keeps the whole [dk, dv+1] f32 state
//   in VMEM (591 KB at dk = dv = 384; a block here has 227 KB).  Here only
//   the state recurrence is sequential:
//     - forward, state pass: one block per (64 rows of dk, 64 columns of
//       dv, b*h) keeps its slice of C as a wgmma accumulator and walks the
//       chunks, storing the state entering each one and adding (k w)^T v;
//       output pass: one block per (64 rows of a chunk, b*h), all chunks at
//       once: S = q k^T once, A and the normalizer in f32, then q C + A v
//       for every 64 columns of dv;
//     - backward, deterministic (no atomics; every cross-block sum in a
//       fixed order): the prep kernel (g); a state-gradient pass, the state
//       pass in reverse, storing dC leaving every chunk and <dC, C>
//       partials; a key-side kernel (rows s: dk, dv, di) and a query-side
//       kernel (rows t: dq), each one block per (64 rows of a chunk, b*h)
//       computing its S and dA once and walking every column tile of its
//       outputs, so dq and dk are written once, never as per-tile partials;
//       a gates kernel adds the chunk's db terms and reverse-sums them.
//     - numerics: q, k, v, dout are bf16 inputs, exact as wgmma operands;
//       every f32 intermediate that meets them in a product (k w, C, A,
//       dC, dout / den, A / den, dS) goes in as a bf16 pair hi = bf16(x),
//       lo = bf16(x - hi), two products into one f32 sum: ~16 bits of its
//       mantissa.  (Rounding each of them to bf16 once instead puts the
//       final state past its 2e-3 limit at the xlstm shape; see
//       tests/test_torch_gla_scan.py.)  Gates, masks, normalizers and
//       every sum are f32; S is scaled after its product.
//     - memory: tiles are 64-column bf16 panels swizzled over 128 bytes,
//       loaded by cp.async (zero-filled past T, L, dk, dv), in the
//       per-chunk kernels through two-stage rings (the next slice loads
//       while the current one multiplies), and read by wgmma K-major or
//       MN-major; chunks are padded to 64 or 128 rows (LP).  The chunk
//       states and their gradients (151 MB each at the xlstm shape) go to
//       device memory already split and swizzled, as the panel pairs the
//       products read, 16 bytes a thread through a staging pair in shared
//       memory: kept as f32 rows of dv + 1 columns, their scattered stores
//       and split-on-load were the largest cost of the first version.
// * f32: the SIMT kernels below (f32 in and out; the prep kernel is
//   shared with the bf16 route):
//   - the scores S of every chunk are independent of the state: one block
//     per (chunk, b*h) computes them first into an f32 buffer (a register
//     tile of 8 x 8 per thread over dk slices of 16 staged in shared memory);
//   - the scan: one block per (value tile of 32 columns, b*h) walks the
//     chunks in order, carrying its own [dk, 32] slice of the state plus its
//     own copy of the normalizer column in shared memory, so every tile can
//     divide its outputs without talking to the others.  q and k of a chunk
//     are staged through shared memory in slices of 16 of dk;
//   - the backward: the same tiling in reverse.  dv is tile-local; dq, dk and
//     the gate gradients are sums over all value columns, so each tile writes
//     f32 partials (tile 0 also carries the normalizer column) and a reduce
//     kernel adds them in tile order: deterministic, no atomics.  The forward
//     saves the state entering every chunk and the normalizer of every step
//     when a gradient is wanted; the backward recomputes the scores.
//   - everything is f32.
// Built without fast math: expf is the accurate one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

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

struct Dims {
  int BH, T, dk, dv, L, nc, normalize;
  float scale;
};

// ---------------------------------------------------------------------------
// scores: S[bh, c, t, s] = (q_t * scale) . k_s for s <= t, else 0
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
gla_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
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
        qv = q[off] * d.scale;
        kv = k[off];
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
__device__ void load_vhat(const float* __restrict__ v, int bh, int c, int j0,
                          int ncols, const Dims& d, float* vh) {
  const int L = d.L;
  for (int e = threadIdx.x; e < L * kCols; e += kThreads) {
    const int t = e / kCols, j = e % kCols, pos = c * L + t;
    float val = 0.f;
    if (j == kTile)
      val = 1.f;
    else if (j < ncols && pos < d.T)
      val = v[(static_cast<long long>(bh) * d.T + pos) * d.dv + j0 + j];
    vh[t * kCols + j] = val;
  }
}

// a dk slice [L][kSl] of q (scaled) or k, zeros past T
__device__ void load_slice(const float* __restrict__ x, int bh, int c, int i0,
                           float mul, const Dims& d, float* sl) {
  const int L = d.L;
  for (int e = threadIdx.x; e < L * kSlice; e += kThreads) {
    const int r = e / kSlice, col = e % kSlice, pos = c * L + r;
    float val = 0.f;
    if (pos < d.T)
      val = x[(static_cast<long long>(bh) * d.T + pos) * d.dk + i0 + col] * mul;
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

__global__ void __launch_bounds__(kThreads, 1)
gla_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lf,
               const float* __restrict__ ig, const float* __restrict__ S,
               float* __restrict__ out, float* __restrict__ state,
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
      float* orow =
          out + (static_cast<long long>(bh) * d.T + pos) * d.dv + j0;
#pragma unroll
      for (int m = 0; m < kHalfCols; ++m) {
        const int j = jh + 2 * m;
        if (j < ncols)
          orow[j] = d.normalize ? acc[m] / den : acc[m];
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
          val = k[(static_cast<long long>(bh) * d.T + pos) * dk + i0 + kk] *
                w[s];
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

__global__ void __launch_bounds__(kThreads, 1)
gla_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lf,
               const float* __restrict__ ig, const float* __restrict__ dout,
               const float* __restrict__ states,
               const float* __restrict__ norms, const float* __restrict__ S,
               const float* __restrict__ g, float* __restrict__ dq_part,
               float* __restrict__ dk_part, float* __restrict__ dlf_part,
               float* __restrict__ dig_part, float* __restrict__ dv_out,
               Dims d) {
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
          val = dout[(base + pos) * d.dv + j0 + j] / den[t];
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
      float* drow = dv_out + (base + pos) * d.dv + j0;
#pragma unroll
      for (int m = 0; m < kHalfCols; ++m) {
        const int j = jh + 2 * m;
        if (j < ncols) drow[j] = dva[m];
      }
    }
  }
}

// fixed-order sums of the tiles' partials; dq also takes the q scale
__global__ void __launch_bounds__(kThreads)
gla_bwd_reduce_kernel(const float* __restrict__ dq_part,
                      const float* __restrict__ dk_part,
                      const float* __restrict__ dlf_part,
                      const float* __restrict__ dig_part,
                      float* __restrict__ dq, float* __restrict__ dk,
                      float* __restrict__ dlf,
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
    dq[i] = a * scale;
    dk[i] = b;
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

int launch_fwd(const float* q, const float* k, const float* v,
               const float* lf, const float* ig, float* out, float* state,
               float* S, float* states, float* norms, Dims d,
               cudaStream_t st) {
  gla_scores_kernel<<<dim3(d.nc, d.BH), kThreads, 0, st>>>(q, k, S, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * fwd_smem_floats(d.dk, d.L);
  err = cudaFuncSetAttribute(gla_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (d.dv + kTile - 1) / kTile;
  gla_fwd_kernel<<<dim3(nt, d.BH), kThreads, smem, st>>>(
      q, k, v, lf, ig, S, out, state, states, norms, d);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd(const float* q, const float* k, const float* v,
               const float* lf, const float* ig, const float* out,
               const float* dout, const float* states, const float* norms,
               float* S, float* g, float* dq_part, float* dk_part,
               float* dlf_part, float* dig_part, float* dq, float* dk,
               float* dv, float* dlf, float* dig, Dims d, cudaStream_t st) {
  gla_scores_kernel<<<dim3(d.nc, d.BH), kThreads, 0, st>>>(q, k, S, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(d.BH) * d.T;
  const long long pgrid = (rows + kThreads / 32 - 1) / (kThreads / 32);
  gla_bwd_prep_kernel<float><<<static_cast<unsigned>(pgrid), kThreads, 0,
                                st>>>(out, dout, norms, g, rows, d.dv,
                                      d.normalize);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * bwd_smem_floats(d.dk, d.L);
  err = cudaFuncSetAttribute(gla_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (d.dv + kTile - 1) / kTile;
  gla_bwd_kernel<<<dim3(nt, d.BH), kThreads, smem, st>>>(
      q, k, v, lf, ig, dout, states, norms, S, g, dq_part, dk_part, dlf_part,
      dig_part, dv, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_qk = rows * d.dk;
  long long grid = (n_qk + kThreads - 1) / kThreads;
  if (grid > 132 * 16) grid = 132 * 16;
  gla_bwd_reduce_kernel<<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
      dq_part, dk_part, dlf_part, dig_part, dq, dk, dlf, dig, nt, n_qk, rows,
      d.scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: every product on wgmma, the chunks in parallel
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWg = 128;  // one warpgroup a block: the wgmma threads load too
constexpr int kA = 64 * 128;  // bytes of a [64, 64] bf16 panel

// The chunk's gates in shared memory for rows [0, 128): b = cumsum of
// log_f (flat past L), eb = exp(b) (0 past L), i and w = exp(b_L - b) i
// (0 past L and past T), den (max(|norm|, 1) under normalize, else 1) and g
// (0 past T) when `norms` is given.  The cumulative sum is one warp's scan
// in a fixed order.  Ends synced.
struct Gates {
  float b[128], eb[128], is[128], w[128], den[128], g[128];
};

__device__ void chunk_gates(const float* __restrict__ lf,
                            const float* __restrict__ ig,
                            const float* __restrict__ norms,
                            const float* __restrict__ g, int bh, int c,
                            const Dims& d, Gates* gt) {
  const int t = threadIdx.x, L = d.L, pos = c * L + t;
  const bool ok = t < L && pos < d.T;
  const long long off = static_cast<long long>(bh) * d.T + pos;
  gt->b[t] = ok ? lf[off] : 0.f;
  gt->is[t] = ok ? ig[off] : 0.f;
  if (norms != nullptr) {
    gt->den[t] = ok && d.normalize ? fmaxf(fabsf(norms[off]), 1.f) : 1.f;
    gt->g[t] = ok ? g[off] : 0.f;
  }
  __syncthreads();
  if (t < 32) {  // 4 rows a lane, then an inclusive scan over the lanes
    float x[4], run = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      run += gt->b[4 * t + j];
      x[j] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, o);
      if (t >= o) incl += y;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (t == 0) excl = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) gt->b[4 * t + j] = excl + x[j];
  }
  __syncthreads();
  gt->eb[t] = t < L ? expf(gt->b[t]) : 0.f;
  gt->w[t] = expf(gt->b[L - 1] - gt->b[t]) * gt->is[t];
  __syncthreads();
}

// rows [0, rows) of a bf16 panel: global row `row0 + r` of a [*, width]
// matrix (valid while r < nvalid), columns col0 .. col0 + 63 (valid while
// < width); zeros elsewhere.  Asynchronous (cp.async)
__device__ __forceinline__ void load_panel(uint8_t* dst,
                                           const bf16* __restrict__ src,
                                           long long row0, int rows,
                                           int nvalid, int col0, int width) {
  for (int e = threadIdx.x; e < rows * 8; e += kWg) {
    const int r = e >> 3, ch = e & 7, col = col0 + ch * 8;
    const bool ok = r < nvalid && col < width;
    cp_async16(dst + sw128(r, ch), ok ? src + (row0 + r) * width + col : src,
               ok);
  }
}

// The bf16 route keeps the state entering every chunk (and, in the
// backward, the gradient of the state leaving it) as hi/lo bf16 panel
// pairs, already in the shared-memory layout: 64 rows of dk x 64 columns
// of dv, the hi panel (8 KB) then the lo panel, one pair per (b*h, chunk,
// dk tile, dv tile), zeros past dk and dv; the normalizer column is f32
// [b*h, chunk, dk] beside them.  A pair loads as 16 KB of cp.async and is
// stored from a staging pair in shared memory, both in 16-byte pieces.
constexpr int kPair = 2 * 64 * 128;

__device__ __forceinline__ long long pair_index(const Dims& d, int bh, int c,
                                                int it, int jt) {
  const int ndk = (d.dk + 63) / 64, ndv = (d.dv + 63) / 64;
  return ((static_cast<long long>(bh) * d.nc + c) * ndk + it) * ndv + jt;
}

// the pair (it, jt) of chunk c into hi and lo = hi + 8 KB; asynchronous
__device__ __forceinline__ void load_pair(uint8_t* dst,
                                          const bf16* __restrict__ tiles,
                                          const Dims& d, int bh, int c, int it,
                                          int jt) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(tiles) +
                       pair_index(d, bh, c, it, jt) * kPair;
  for (int e = threadIdx.x; e < kPair / 16; e += kWg)
    cp_async16(dst + 16 * e, src + 16 * e, true);
}

// an m64n64 f32 accumulator as a hi/lo pair of panels in shared memory
__device__ __forceinline__ void stage_split(const float (&x)[32], uint8_t* hi,
                                            uint8_t* lo) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int r = r0 + 8 * frag_row(e), col = frag_col(e, lane);
    const uint32_t off = sw128(r, col >> 3) + (col & 7) * 2;
    split_bf16(x[e], x[e + 1], reinterpret_cast<uint32_t*>(hi + off),
               reinterpret_cast<uint32_t*>(lo + off));
  }
}

// sum over 8 elements of (ah + al)(bh + bl), four hi/lo pieces of 16 bytes
__device__ __forceinline__ float dot_pairs(uint4 ah, uint4 al, uint4 bh,
                                           uint4 bl) {
  const bf16* a = reinterpret_cast<const bf16*>(&ah);
  const bf16* b = reinterpret_cast<const bf16*>(&al);
  const bf16* c = reinterpret_cast<const bf16*>(&bh);
  const bf16* e = reinterpret_cast<const bf16*>(&bl);
  float x = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    x += (__bfloat162float(a[j]) + __bfloat162float(b[j])) *
         (__bfloat162float(c[j]) + __bfloat162float(e[j]));
  return x;
}

// the bf16 at (row r, column col) of a panel
__device__ __forceinline__ float panel_at(const uint8_t* p, int r, int col) {
  return __bfloat162float(
      *reinterpret_cast<const bf16*>(p + sw128(r, col >> 3) + (col & 7) * 2));
}

template <int N>
__device__ __forceinline__ void wg_done(float (&d)[N]) {
  wg_commit();
  wg_wait();
  fence_regs(d);
}

// rows of a chunk that exist: min(L, T - c L), counted from row `from`
__device__ __forceinline__ int chunk_rows(const Dims& d, int c, int from) {
  return min(d.L, d.T - c * d.L) - from;
}

// Stages 0 .. n-1 through a two-stage ring of shared-memory buffers:
// issue(p, buf) starts stage p's cp.async loads into buffer buf, and stage
// p + 1's are in flight while compute(p, buf) runs stage p's products.
// Loads the caller started before the call land with stage 0.
template <typename Issue, typename Compute>
__device__ __forceinline__ void ring(int n, Issue issue, Compute compute) {
  issue(0, 0);
  cp_async_commit();
  for (int p = 0; p < n; ++p) {
    if (p + 1 < n) {
      issue(p + 1, (p + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    compute(p, p & 1);
    __syncthreads();
  }
}

// an m64n64 accumulator's rows (x mul / div of each row) as bf16 into rows
// row0 + r (r below nrows) and columns col0 .. col0 + 63 (below width) of
// a [*, width] matrix
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst,
                                           long long row0, int nrows,
                                           int col0, int width,
                                           const float (&x)[32],
                                           const float (&mul)[2],
                                           const float (&div)[2]) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= nrows) continue;
    bf16* row = dst + (row0 + r) * width;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = col0 + 8 * jj + (lane & 3) * 2;
      if (j < width)
        *reinterpret_cast<__nv_bfloat162*>(row + j) = __floats2bfloat162_rn(
            x[4 * jj + 2 * h] * mul[h] / div[h],
            x[4 * jj + 2 * h + 1] * mul[h] / div[h]);
    }
  }
}

// ------------------------------- forward ----------------------------------

// The state pass: one block per (64 rows of dk, 64 columns of dv, b*h)
// keeps its slice of C as a wgmma accumulator and walks the chunks,
// storing the state entering each one, then C <- exp(b_L) C + (k w)^T v
// with k w as a hi/lo pair (A read MN-major: the chunk's rows are the
// reduction).  The dv-tile-0 blocks carry the normalizer column n <-
// exp(b_L) n + sum_s w_s k_s in f32 (two half sums, added in order).
// (Prefetching the next chunk's panels while this one multiplies was
// tried: no faster, at twice the shared memory.)
template <int LP>
struct StateSmem {
  static constexpr int PANEL = LP * 128;
  static constexpr int BYTES =
      1024 + 4 * PANEL + static_cast<int>(sizeof(Gates)) + 128 * 4;
};

template <int LP>
__global__ void __launch_bounds__(kWg)
gla_tc_state_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const float* __restrict__ lf, const float* __restrict__ ig,
                    float* __restrict__ state, bf16* __restrict__ tiles,
                    float* __restrict__ tiles_n, Dims d) {
  constexpr int PANEL = StateSmem<LP>::PANEL;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* kp = align1024(smem_raw);  // [LP, 64]: k of the chunk
  uint8_t* vp = kp + PANEL;           // [LP, 64]: v
  uint8_t* hi = vp + PANEL;           // [LP, 64]: k w, hi and lo
  uint8_t* lo = hi + PANEL;
  Gates* gt = reinterpret_cast<Gates*>(lo + PANEL);
  float* npart = reinterpret_cast<float*>(gt + 1);  // [128]
  const int i0 = blockIdx.x * 64, j0 = blockIdx.y * 64, bh = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int ld = d.dv + 1;
  const bool norm_blk = blockIdx.y == 0;
  const bool norm_col = norm_blk && tid < 64 && i0 + tid < d.dk;
  float C[32], n = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) C[e] = 0.f;
  const uint32_t hi_a = smem_u32(hi), lo_a = smem_u32(lo), v_a = smem_u32(vp);

  for (int c = 0; c < d.nc; ++c) {
    // the state entering chunk c, through the (free) k w panels
    stage_split(C, hi, lo);
    if (norm_col)
      tiles_n[(static_cast<long long>(bh) * d.nc + c) * d.dk + i0 + tid] = n;
    __syncthreads();
    {
      uint8_t* dst = reinterpret_cast<uint8_t*>(tiles) +
                     pair_index(d, bh, c, blockIdx.x, blockIdx.y) * kPair;
      for (int e = tid; e < kPair / 16; e += kWg)
        *reinterpret_cast<uint4*>(dst + 16 * e) = *reinterpret_cast<const uint4*>(
            (e < kPair / 32 ? hi : lo - kPair / 2) + 16 * e);
    }
    const long long row0 = static_cast<long long>(bh) * d.T + c * d.L;
    const int rows = chunk_rows(d, c, 0);
    load_panel(kp, k, row0, LP, rows, i0, d.dk);
    load_panel(vp, v, row0, LP, rows, j0, d.dv);
    chunk_gates(lf, ig, nullptr, nullptr, bh, c, d, gt);
    cp_async_wait_all();
    __syncthreads();
    if (norm_blk) {  // half of the rows of column tid % 64
      const int col = tid & 63, s0 = (tid >> 6) * (LP / 2);
      float x = 0.f;
      for (int s = s0; s < s0 + LP / 2; ++s) x += gt->w[s] * panel_at(kp, s, col);
      npart[tid] = x;
    }
    for (int e = tid; e < LP * 8; e += kWg) {  // k w as a hi/lo pair
      const int s = e >> 3, ch = e & 7;
      const float ws = gt->w[s];
      const uint4 raw = *reinterpret_cast<const uint4*>(kp + sw128(s, ch));
      const bf16* kv = reinterpret_cast<const bf16*>(&raw);
      uint32_t h[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_bf16(__bfloat162float(kv[2 * j]) * ws,
                   __bfloat162float(kv[2 * j + 1]) * ws, &h[j], &l[j]);
      *reinterpret_cast<uint4*>(hi + sw128(s, ch)) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + sw128(s, ch)) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    fence_async_smem();
    __syncthreads();
    const float ebL = gt->eb[d.L - 1];
    if (norm_col) n = ebL * n + (npart[tid] + npart[tid + 64]);
#pragma unroll
    for (int e = 0; e < 32; ++e) C[e] *= ebL;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < LP / 16; ++kk) {
      wgmma_ss<1, 1>(C, mnmajor<64, LP>(hi_a, kk), mnmajor<64, LP>(v_a, kk), 1);
      wgmma_ss<1, 1>(C, mnmajor<64, LP>(lo_a, kk), mnmajor<64, LP>(v_a, kk), 1);
    }
    wg_done(C);
    __syncthreads();
  }
  float* dst = state + static_cast<long long>(bh) * d.dk * ld;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int i = i0 + r0 + 8 * frag_row(e), j = j0 + frag_col(e, lane);
    if (i < d.dk && j < d.dv) dst[static_cast<long long>(i) * ld + j] = C[e];
  }
  if (norm_col) dst[static_cast<long long>(i0 + tid) * ld + d.dv] = n;
}

// The output pass: one block per (64 rows of a chunk, b*h), all chunks at
// once, from the state entering the chunk.  Over dk slices of 64, q kept
// in shared memory: S += q k^T (N = the chunk's rows) and q . n on the CUDA
// cores; then A = scale S exp(b_t - b_s) i_s (selected before the exp),
// the normalizer rowsum(A) + exp(b_t) scale q . n in f32, and A as a hi/lo
// pair of register operands.  Then for every 64 columns of dv: O = q C
// over dk (C's panel pairs through a two-stage ring), O = exp(b_t) scale O
// + A v, out = O / max(|n|, 1).  S is computed once for all of dv.
constexpr int kMaxDkTiles = kMaxDk / 64;

template <int LP>
struct OutSmem {
  static constexpr int BYTES = 1024 + kMaxDkTiles * kA + LP * 128 +
                               2 * kPair + static_cast<int>(sizeof(Gates)) +
                               (kMaxDk + 64) * 4;
};

template <int LP>
__global__ void __launch_bounds__(kWg)
gla_tc_out_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ lf,
                  const float* __restrict__ ig, const bf16* __restrict__ tiles,
                  const float* __restrict__ tiles_n, bf16* __restrict__ out,
                  float* __restrict__ norms, Dims d) {
  constexpr int NRT = LP / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qp = align1024(smem_raw);    // [dk / 64][64, 64]: q
  uint8_t* vp = qp + kMaxDkTiles * kA;  // [LP, 64]: v
  uint8_t* cpair = vp + LP * 128;       // [2] C pairs (first, k panels)
  Gates* gt = reinterpret_cast<Gates*>(cpair + 2 * kPair);
  float* nvec = reinterpret_cast<float*>(gt + 1);  // [dk] n entering the chunk
  float* qn_s = nvec + kMaxDk;                     // [64] q . n
  const int c = blockIdx.x / NRT, rt = blockIdx.x % NRT, bh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int ndk = (d.dk + 63) / 64;
  const long long crow = static_cast<long long>(bh) * d.T + c * d.L;
  const int rows = chunk_rows(d, c, 0), my_rows = chunk_rows(d, c, 64 * rt);
  const float* nc_ = tiles_n + (static_cast<long long>(bh) * d.nc + c) * d.dk;
  for (int i = tid; i < ndk * 64; i += kWg) nvec[i] = i < d.dk ? nc_[i] : 0.f;
  chunk_gates(lf, ig, nullptr, nullptr, bh, c, d, gt);

  float S[LP / 2], qn = 0.f;
#pragma unroll
  for (int e = 0; e < LP / 2; ++e) S[e] = 0.f;
  const uint32_t q_a = smem_u32(qp), v_a = smem_u32(vp), c_a = smem_u32(cpair);
  ring(ndk, [&](int p, int b) {  // S = q k^T; k through the C pairs' ring
    load_panel(qp + p * kA, q, crow + 64 * rt, 64, my_rows, 64 * p, d.dk);
    load_panel(cpair + b * kPair, k, crow, LP, rows, 64 * p, d.dk);
  }, [&](int p, int b) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(S, kmajor<64, 64>(q_a + p * kA, kk),
                     kmajor<64, LP>(c_a + b * kPair, kk), 1);
    wg_commit();
    {  // q . n while the product runs: two threads a row, 32 columns each
      const int r = tid >> 1, h = (tid & 1) * 4;
#pragma unroll
      for (int m = h; m < h + 4; ++m) {
        const uint4 raw = *reinterpret_cast<const uint4*>(qp + p * kA + sw128(r, m));
        const bf16* x = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) qn += __bfloat162float(x[j]) * nvec[64 * p + 8 * m + j];
      }
    }
    wg_wait();
    fence_regs(S);
  });
  qn += __shfl_xor_sync(0xffffffffu, qn, 1);
  if ((tid & 1) == 0) qn_s[tid >> 1] = qn;
  __syncthreads();

  float nrm[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < LP / 2; ++e) {
    const int t = 64 * rt + r0 + 8 * frag_row(e), s = frag_col(e, lane);
    float a = 0.f;
    if (s <= t && t < d.L)
      a = d.scale * S[e] * expf(gt->b[t] - gt->b[s]) * gt->is[s];
    S[e] = a;
    nrm[frag_row(e)] += a;
  }
  float den[2], f[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tl = r0 + 8 * h, t = 64 * rt + tl;
    f[h] = gt->eb[t] * d.scale;
    nrm[h] = quad_sum(nrm[h]) + f[h] * qn_s[tl];
    den[h] = d.normalize ? fmaxf(fabsf(nrm[h]), 1.f) : 1.f;
    if (norms != nullptr && tl < my_rows && (lane & 3) == 0)
      norms[crow + 64 * rt + tl] = nrm[h];
  }
  uint32_t ah[LP / 16][4], al[LP / 16][4];
  to_operand_split<LP>(S, ah, al);

  for (int j0 = 0; j0 < d.dv; j0 += 64) {  // O = q C + A v, one dv tile
    float O[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) O[e] = 0.f;
    load_panel(vp, v, crow, LP, rows, j0, d.dv);
    ring(ndk, [&](int p, int b) {
      load_pair(cpair + b * kPair, tiles, d, bh, c, p, j0 / 64);
    }, [&](int p, int b) {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t qd = kmajor<64, 64>(q_a + p * kA, kk);
        wgmma_ss<0, 1>(O, qd, mnmajor<64, 64>(c_a + b * kPair, kk), 1);
        wgmma_ss<0, 1>(O, qd, mnmajor<64, 64>(c_a + b * kPair + kPair / 2, kk), 1);
      }
      wg_done(O);
    });
#pragma unroll
    for (int e = 0; e < 32; ++e) O[e] *= f[frag_row(e)];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < LP / 16; ++kk) {
      Wgmma<64>::rs(O, ah[kk], mnmajor<64, LP>(v_a, kk), 1);
      Wgmma<64>::rs(O, al[kk], mnmajor<64, LP>(v_a, kk), 1);
    }
    wg_done(O);
    __syncthreads();
    const float one[2] = {1.f, 1.f};
    store_tile(out, crow + 64 * rt, my_rows, j0, d.dv, O, one, den);
  }
}

// ------------------------------- backward ---------------------------------

// The state-gradient pass: the state pass in reverse.  One block per (64
// rows of dk, 64 columns of dv, b*h) keeps its slice of dC (the gradient
// of the state leaving the chunk) and walks the chunks from the last,
// storing dC and its share of <dC, C> (partial sums in a fixed order),
// then dC <- exp(b_L) dC + q^T (scale exp(b_t) / den_t dout) with the
// right factor as a hi/lo pair; the dv-tile-0 blocks carry the normalizer
// column, dn <- exp(b_L) dn + sum_t scale exp(b_t) g_t q_t, in f32.
template <int LP>
__global__ void __launch_bounds__(kWg)
gla_tc_dstate_kernel(const bf16* __restrict__ q, const bf16* __restrict__ dout,
                     const float* __restrict__ lf, const float* __restrict__ ig,
                     const float* __restrict__ norms,
                     const float* __restrict__ g,
                     const bf16* __restrict__ tiles,
                     const float* __restrict__ tiles_n,
                     bf16* __restrict__ dtiles, float* __restrict__ dtiles_n,
                     float* __restrict__ dcc, Dims d) {
  constexpr int PANEL = StateSmem<LP>::PANEL;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qp = align1024(smem_raw);  // [LP, 64]: q of the chunk
  uint8_t* dp = qp + PANEL;           // [LP, 64]: dout
  uint8_t* hi = dp + PANEL;           // [LP, 64]: the scaled dout, hi and lo
  uint8_t* lo = hi + PANEL;
  Gates* gt = reinterpret_cast<Gates*>(lo + PANEL);
  float* npart = reinterpret_cast<float*>(gt + 1);  // [128]
  __shared__ float red[4];
  const int i0 = blockIdx.x * 64, j0 = blockIdx.y * 64, bh = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.x * gridDim.y + blockIdx.y;
  const bool norm_blk = blockIdx.y == 0;
  const bool norm_col = norm_blk && tid < 64 && i0 + tid < d.dk;
  float dC[32], dn = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) dC[e] = 0.f;
  const uint32_t q_a = smem_u32(qp), hi_a = smem_u32(hi), lo_a = smem_u32(lo);

  for (int c = d.nc - 1; c >= 0; --c) {
    // dC leaving chunk c, through the (free) dout panels, and its share of
    // <dC, C> (both as hi/lo pairs)
    stage_split(dC, hi, lo);
    float part = 0.f;
    if (norm_col) {
      const long long o = (static_cast<long long>(bh) * d.nc + c) * d.dk + i0 + tid;
      dtiles_n[o] = dn;
      part = dn * tiles_n[o];
    }
    __syncthreads();
    {
      const long long o = pair_index(d, bh, c, blockIdx.x, blockIdx.y) * kPair;
      uint8_t* dst = reinterpret_cast<uint8_t*>(dtiles) + o;
      const uint8_t* cs = reinterpret_cast<const uint8_t*>(tiles) + o;
      for (int e = tid; e < kPair / 32; e += kWg) {
        const uint4 dh = *reinterpret_cast<const uint4*>(hi + 16 * e);
        const uint4 dl = *reinterpret_cast<const uint4*>(lo + 16 * e);
        *reinterpret_cast<uint4*>(dst + 16 * e) = dh;
        *reinterpret_cast<uint4*>(dst + kPair / 2 + 16 * e) = dl;
        part += dot_pairs(dh, dl, *reinterpret_cast<const uint4*>(cs + 16 * e),
                          *reinterpret_cast<const uint4*>(cs + kPair / 2 + 16 * e));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) red[tid >> 5] = part;
    const long long row0 = static_cast<long long>(bh) * d.T + c * d.L;
    const int rows = chunk_rows(d, c, 0);
    load_panel(qp, q, row0, LP, rows, i0, d.dk);
    load_panel(dp, dout, row0, LP, rows, j0, d.dv);
    chunk_gates(lf, ig, norms, g, bh, c, d, gt);  // syncs: red is complete
    if (tid == 0)
      dcc[(static_cast<long long>(bh) * d.nc + c) * n_tiles + tile] =
          red[0] + red[1] + red[2] + red[3];
    cp_async_wait_all();
    __syncthreads();
    if (norm_blk) {  // half of the rows of column tid % 64
      const int col = tid & 63, t0 = (tid >> 6) * (LP / 2);
      float x = 0.f;
      for (int t = t0; t < t0 + LP / 2; ++t)
        x += d.scale * gt->eb[t] * gt->g[t] * panel_at(qp, t, col);
      npart[tid] = x;
    }
    for (int e = tid; e < LP * 8; e += kWg) {  // scale eb / den dout, hi/lo
      const int t = e >> 3, ch = e & 7;
      const float f = d.scale * gt->eb[t] / gt->den[t];
      const uint4 raw = *reinterpret_cast<const uint4*>(dp + sw128(t, ch));
      const bf16* x = reinterpret_cast<const bf16*>(&raw);
      uint32_t h[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_bf16(__bfloat162float(x[2 * j]) * f,
                   __bfloat162float(x[2 * j + 1]) * f, &h[j], &l[j]);
      *reinterpret_cast<uint4*>(hi + sw128(t, ch)) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + sw128(t, ch)) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    fence_async_smem();
    __syncthreads();
    const float ebL = gt->eb[d.L - 1];
    if (norm_col) dn = ebL * dn + (npart[tid] + npart[tid + 64]);
#pragma unroll
    for (int e = 0; e < 32; ++e) dC[e] *= ebL;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < LP / 16; ++kk) {
      wgmma_ss<1, 1>(dC, mnmajor<64, LP>(q_a, kk), mnmajor<64, LP>(hi_a, kk), 1);
      wgmma_ss<1, 1>(dC, mnmajor<64, LP>(q_a, kk), mnmajor<64, LP>(lo_a, kk), 1);
    }
    wg_done(dC);
    __syncthreads();
  }
}

// Shared memory of the two per-chunk gradient kernels
template <int LP>
struct BwdSmem {
  static constexpr int BYTES = 1024 + 3 * kA + 2 * LP * 128 + 2 * kPair +
                               static_cast<int>(sizeof(Gates)) + 64 * 4;
};

// The key side of a chunk's gradients: one block per (64 rows s of a
// chunk, b*h).  S^T = k q^T and dA^T = v dout^T over the chunk's rows t;
// then A^T, dS^T and E^T (masks selected before the exp), E's sums over t;
// then, per 64 columns, dv = (A^T / den) dout + w (k dC) and dk = scale dS^T
// q + w u with u = v^ dC^T (f32 operands as hi/lo pairs), dw = k . u; di,
// and the key-side terms of db: -i colE - dw w, and dw w for the chunk's
// total.
template <int LP>
__global__ void __launch_bounds__(kWg)
gla_tc_bwd_key_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lf,
                      const float* __restrict__ ig,
                      const float* __restrict__ norms,
                      const float* __restrict__ g,
                      const bf16* __restrict__ dtiles,
                      const float* __restrict__ dtiles_n,
                      bf16* __restrict__ dk_out, bf16* __restrict__ dv_out,
                      float* __restrict__ di, float* __restrict__ dbk,
                      float* __restrict__ dww, Dims d) {
  constexpr int NRT = LP / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ap = align1024(smem_raw);  // [2][64, 64]: k or v of the block's rows
  uint8_t* ap2 = ap + 2 * kA;         // [64, 64]: k of the block's rows
  uint8_t* bp = ap2 + kA;             // [2][LP, 64]: q or dout of the chunk
  uint8_t* pr = bp + 2 * LP * 128;    // [2] dC pairs
  Gates* gt = reinterpret_cast<Gates*>(pr + 2 * kPair);
  float* nsl = reinterpret_cast<float*>(gt + 1);  // [64] dn of the dk tile
  const int c = blockIdx.x / NRT, rt = blockIdx.x % NRT, bh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const long long crow = static_cast<long long>(bh) * d.T + c * d.L;
  const long long mrow = crow + 64 * rt;
  const int rows = chunk_rows(d, c, 0), my_rows = chunk_rows(d, c, 64 * rt);
  const float* dn_ = dtiles_n + (static_cast<long long>(bh) * d.nc + c) * d.dk;
  const uint32_t a_a = smem_u32(ap), b_a = smem_u32(bp), p_a = smem_u32(pr);
  const int ndk = (d.dk + 63) / 64, ndv = (d.dv + 63) / 64;
  chunk_gates(lf, ig, norms, g, bh, c, d, gt);

  float St[LP / 2], dAt[LP / 2];
#pragma unroll
  for (int e = 0; e < LP / 2; ++e) St[e] = dAt[e] = 0.f;
  ring(ndk, [&](int p, int b) {  // S^T = k q^T
    load_panel(ap + b * kA, k, mrow, 64, my_rows, 64 * p, d.dk);
    load_panel(bp + b * LP * 128, q, crow, LP, rows, 64 * p, d.dk);
  }, [&](int, int b) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(St, kmajor<64, 64>(a_a + b * kA, kk),
                     kmajor<64, LP>(b_a + b * LP * 128, kk), 1);
    wg_done(St);
  });
  ring(ndv, [&](int p, int b) {  // dA^T (before / den, + g) = v dout^T
    load_panel(ap + b * kA, v, mrow, 64, my_rows, 64 * p, d.dv);
    load_panel(bp + b * LP * 128, dout, crow, LP, rows, 64 * p, d.dv);
  }, [&](int, int b) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(dAt, kmajor<64, 64>(a_a + b * kA, kk),
                     kmajor<64, LP>(b_a + b * LP * 128, kk), 1);
    wg_done(dAt);
  });

  float colE[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < LP / 2; ++e) {
    const int s = 64 * rt + r0 + 8 * frag_row(e), t = frag_col(e, lane);
    float a = 0.f, ds = 0.f;
    if (s <= t && t < d.L) {
      const float ex = expf(gt->b[t] - gt->b[s]);
      const float dA = dAt[e] / gt->den[t] + gt->g[t];
      const float sf = d.scale * St[e];
      a = sf * ex * gt->is[s] / gt->den[t];
      ds = d.scale * dA * ex * gt->is[s];
      colE[frag_row(e)] += dA * sf * ex;
    }
    St[e] = a;
    dAt[e] = ds;
  }
  uint32_t p1h[LP / 16][4], p1l[LP / 16][4], p2h[LP / 16][4], p2l[LP / 16][4];
  to_operand_split<LP>(St, p1h, p1l);
  to_operand_split<LP>(dAt, p2h, p2l);

  float acc[32];
  const float one[2] = {1.f, 1.f};
  for (int j0 = 0; j0 < d.dv; j0 += 64) {  // dv = w (k dC) + (A^T / den) dout
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    load_panel(bp, dout, crow, LP, rows, j0, d.dv);
    ring(ndk, [&](int p, int b) {
      load_panel(ap + b * kA, k, mrow, 64, my_rows, 64 * p, d.dk);
      load_pair(pr + b * kPair, dtiles, d, bh, c, p, j0 / 64);
    }, [&](int, int b) {
      const uint32_t pa = p_a + b * kPair;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t ad = kmajor<64, 64>(a_a + b * kA, kk);
        wgmma_ss<0, 1>(acc, ad, mnmajor<64, 64>(pa, kk), 1);
        wgmma_ss<0, 1>(acc, ad, mnmajor<64, 64>(pa + kPair / 2, kk), 1);
      }
      wg_done(acc);
    });
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] *= gt->w[64 * rt + r0 + 8 * frag_row(e)];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < LP / 16; ++kk) {
      Wgmma<64>::rs(acc, p1h[kk], mnmajor<64, LP>(b_a, kk), 1);
      Wgmma<64>::rs(acc, p1l[kk], mnmajor<64, LP>(b_a, kk), 1);
    }
    wg_done(acc);
    __syncthreads();
    store_tile(dv_out, mrow, my_rows, j0, d.dv, acc, one, one);
  }

  float dw[2] = {0.f, 0.f};
  for (int i0 = 0; i0 < d.dk; i0 += 64) {  // dk = w u + scale dS^T q
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    load_panel(ap2, k, mrow, 64, my_rows, i0, d.dk);
    load_panel(bp, q, crow, LP, rows, i0, d.dk);
    if (tid < 64) nsl[tid] = i0 + tid < d.dk ? dn_[i0 + tid] : 0.f;
    ring(ndv, [&](int p, int b) {
      load_panel(ap + b * kA, v, mrow, 64, my_rows, 64 * p, d.dv);
      load_pair(pr + b * kPair, dtiles, d, bh, c, i0 / 64, p);
    }, [&](int, int b) {
      const uint32_t pa = p_a + b * kPair;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t ad = kmajor<64, 64>(a_a + b * kA, kk);
        wgmma_ss<0, 0>(acc, ad, kmajor<64, 64>(pa, kk), 1);
        wgmma_ss<0, 0>(acc, ad, kmajor<64, 64>(pa + kPair / 2, kk), 1);
      }
      wg_done(acc);
    });
#pragma unroll
    for (int e = 0; e < 32; ++e) {  // u = v^ dC^T: the normalizer column
      const int sl = r0 + 8 * frag_row(e), col = frag_col(e, lane);
      acc[e] += nsl[col];
      dw[frag_row(e)] += panel_at(ap2, sl, col) * acc[e];
      acc[e] *= gt->w[64 * rt + sl];
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < LP / 16; ++kk) {
      Wgmma<64>::rs(acc, p2h[kk], mnmajor<64, LP>(b_a, kk), 1);
      Wgmma<64>::rs(acc, p2l[kk], mnmajor<64, LP>(b_a, kk), 1);
    }
    wg_done(acc);
    __syncthreads();
    store_tile(dk_out, mrow, my_rows, i0, d.dk, acc, one, one);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int sl = r0 + 8 * h, s = 64 * rt + sl;
    const float ce = quad_sum(colE[h]), dwv = quad_sum(dw[h]);
    if (sl >= my_rows || (lane & 3) != 0) continue;
    const long long o = mrow + sl;
    di[o] = ce + dwv * expf(gt->b[d.L - 1] - gt->b[s]);
    dbk[o] = -gt->is[s] * ce - dwv * gt->w[s];
    dww[o] = dwv * gt->w[s];
  }
}

// The query side: one block per (64 rows t of a chunk, b*h).  S = q k^T
// and dA = dout v^T / den + g over the chunk's rows s; dS, E and E's
// i-weighted sums over s; then, per 64 columns of dk, r = (dout C^T) / den
// + g n (C as a hi/lo pair), its share of q . r, and dq = scale (dS k
// + exp(b_t) r) (dS as a hi/lo pair); the query-side terms of db.
template <int LP>
__global__ void __launch_bounds__(kWg)
gla_tc_bwd_query_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lf,
                        const float* __restrict__ ig,
                        const float* __restrict__ norms,
                        const float* __restrict__ g,
                        const bf16* __restrict__ tiles,
                        const float* __restrict__ tiles_n,
                        bf16* __restrict__ dq_out, float* __restrict__ dbq,
                        Dims d) {
  constexpr int NRT = LP / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ap = align1024(smem_raw);  // [2][64, 64]: q or dout of the block's rows
  uint8_t* ap2 = ap + 2 * kA;         // [64, 64]: q of the block's rows
  uint8_t* bp = ap2 + kA;             // [2][LP, 64]: k or v of the chunk
  uint8_t* pr = bp + 2 * LP * 128;    // [2] C pairs
  Gates* gt = reinterpret_cast<Gates*>(pr + 2 * kPair);
  float* nsl = reinterpret_cast<float*>(gt + 1);  // [64] n of the dk tile
  const int c = blockIdx.x / NRT, rt = blockIdx.x % NRT, bh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const long long crow = static_cast<long long>(bh) * d.T + c * d.L;
  const long long mrow = crow + 64 * rt;
  const int rows = chunk_rows(d, c, 0), my_rows = chunk_rows(d, c, 64 * rt);
  const float* n_ = tiles_n + (static_cast<long long>(bh) * d.nc + c) * d.dk;
  const uint32_t a_a = smem_u32(ap), b_a = smem_u32(bp), p_a = smem_u32(pr);
  const int ndk = (d.dk + 63) / 64, ndv = (d.dv + 63) / 64;
  chunk_gates(lf, ig, norms, g, bh, c, d, gt);

  float S[LP / 2], dA[LP / 2];
#pragma unroll
  for (int e = 0; e < LP / 2; ++e) S[e] = dA[e] = 0.f;
  ring(ndk, [&](int p, int b) {  // S = q k^T
    load_panel(ap + b * kA, q, mrow, 64, my_rows, 64 * p, d.dk);
    load_panel(bp + b * LP * 128, k, crow, LP, rows, 64 * p, d.dk);
  }, [&](int, int b) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(S, kmajor<64, 64>(a_a + b * kA, kk),
                     kmajor<64, LP>(b_a + b * LP * 128, kk), 1);
    wg_done(S);
  });
  ring(ndv, [&](int p, int b) {  // dout v^T
    load_panel(ap + b * kA, dout, mrow, 64, my_rows, 64 * p, d.dv);
    load_panel(bp + b * LP * 128, v, crow, LP, rows, 64 * p, d.dv);
  }, [&](int, int b) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(dA, kmajor<64, 64>(a_a + b * kA, kk),
                     kmajor<64, LP>(b_a + b * LP * 128, kk), 1);
    wg_done(dA);
  });

  float rowE[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < LP / 2; ++e) {
    const int t = 64 * rt + r0 + 8 * frag_row(e), s = frag_col(e, lane);
    float ds = 0.f;
    if (s <= t && t < d.L) {
      const float ex = expf(gt->b[t] - gt->b[s]);
      const float da = dA[e] / gt->den[t] + gt->g[t];
      ds = da * ex * gt->is[s];
      rowE[frag_row(e)] += da * d.scale * S[e] * ex * gt->is[s];
    }
    dA[e] = ds;
  }
  uint32_t ph[LP / 16][4], pl[LP / 16][4];
  to_operand_split<LP>(dA, ph, pl);

  float acc[32], qr[2] = {0.f, 0.f};
  const float one[2] = {1.f, 1.f}, scale[2] = {d.scale, d.scale};
  for (int i0 = 0; i0 < d.dk; i0 += 64) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    load_panel(ap2, q, mrow, 64, my_rows, i0, d.dk);
    load_panel(bp, k, crow, LP, rows, i0, d.dk);
    if (tid < 64) nsl[tid] = i0 + tid < d.dk ? n_[i0 + tid] : 0.f;
    ring(ndv, [&](int p, int b) {  // dout C^T over dv
      load_panel(ap + b * kA, dout, mrow, 64, my_rows, 64 * p, d.dv);
      load_pair(pr + b * kPair, tiles, d, bh, c, i0 / 64, p);
    }, [&](int, int b) {
      const uint32_t pa = p_a + b * kPair;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t ad = kmajor<64, 64>(a_a + b * kA, kk);
        wgmma_ss<0, 0>(acc, ad, kmajor<64, 64>(pa, kk), 1);
        wgmma_ss<0, 0>(acc, ad, kmajor<64, 64>(pa + kPair / 2, kk), 1);
      }
      wg_done(acc);
    });
#pragma unroll
    for (int e = 0; e < 32; ++e) {  // r = C dN, then exp(b_t) r
      const int tl = r0 + 8 * frag_row(e), t = 64 * rt + tl;
      const int col = frag_col(e, lane);
      const float r = acc[e] / gt->den[t] + gt->g[t] * nsl[col];
      qr[frag_row(e)] += panel_at(ap2, tl, col) * r;
      acc[e] = gt->eb[t] * r;
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < LP / 16; ++kk) {
      Wgmma<64>::rs(acc, ph[kk], mnmajor<64, LP>(b_a, kk), 1);
      Wgmma<64>::rs(acc, pl[kk], mnmajor<64, LP>(b_a, kk), 1);
    }
    wg_done(acc);
    __syncthreads();
    store_tile(dq_out, mrow, my_rows, i0, d.dk, acc, scale, one);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tl = r0 + 8 * h, t = 64 * rt + tl;
    const float re = quad_sum(rowE[h]), qrv = quad_sum(qr[h]);
    if (tl >= my_rows || (lane & 3) != 0) continue;
    dbq[mrow + tl] = re + gt->eb[t] * d.scale * qrv;
  }
}

// The gate gradients of a chunk: db = the query-side and key-side terms,
// plus at the last row exp(b_L) <dC, C> + sum_s dw_s w_s (both added in a
// fixed order); dlog_f is db's reverse cumulative sum.  One block per
// (chunk, b*h).
__global__ void __launch_bounds__(kWg)
gla_tc_bwd_gates_kernel(const float* __restrict__ lf,
                        const float* __restrict__ ig,
                        const float* __restrict__ dbq,
                        const float* __restrict__ dbk,
                        const float* __restrict__ dww,
                        const float* __restrict__ dcc, int n_tiles,
                        float* __restrict__ dlf, Dims d) {
  __shared__ Gates gt;
  __shared__ float db[128], tail[128];
  const int c = blockIdx.x, bh = blockIdx.y, t = threadIdx.x;
  const int pos = c * d.L + t;
  const bool ok = t < d.L && pos < d.T;
  const long long o = static_cast<long long>(bh) * d.T + pos;
  db[t] = ok ? dbq[o] + dbk[o] : 0.f;
  tail[t] = ok ? dww[o] : 0.f;
  chunk_gates(lf, ig, nullptr, nullptr, bh, c, d, &gt);
  if (t == 0) {
    float dwsum = 0.f, cc = 0.f;
    for (int s = 0; s < d.L; ++s) dwsum += tail[s];
    const float* p = dcc + (static_cast<long long>(bh) * d.nc + c) * n_tiles;
    for (int i = 0; i < n_tiles; ++i) cc += p[i];
    db[d.L - 1] += gt.eb[d.L - 1] * cc + dwsum;
    float run = 0.f;
    for (int s = d.L - 1; s >= 0; --s) {
      run += db[s];
      db[s] = run;
    }
  }
  __syncthreads();
  if (ok) dlf[o] = db[t];
}

template <int LP>
int fwd(const void* q, const void* k, const void* v, const float* lf,
        const float* ig, void* out, float* state, void* tiles, float* tiles_n,
        float* norms, const Dims& d, cudaStream_t st) {
  const int ndk = (d.dk + 63) / 64, ndv = (d.dv + 63) / 64;
  const int s_smem = StateSmem<LP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      gla_tc_state_kernel<LP>, cudaFuncAttributeMaxDynamicSharedMemorySize, s_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gla_tc_state_kernel<LP><<<dim3(ndk, ndv, d.BH), kWg, s_smem, st>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), lf, ig, state,
      static_cast<bf16*>(tiles), tiles_n, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int o_smem = OutSmem<LP>::BYTES;
  err = cudaFuncSetAttribute(gla_tc_out_kernel<LP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, o_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gla_tc_out_kernel<LP><<<dim3(d.nc * (LP / 64), d.BH), kWg, o_smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), lf, ig, static_cast<const bf16*>(tiles),
      tiles_n, static_cast<bf16*>(out), norms, d);
  return static_cast<int>(cudaGetLastError());
}

template <int LP>
int bwd(const void* q, const void* k, const void* v, const float* lf,
        const float* ig, const void* out, const void* dout, const void* tiles,
        const float* tiles_n, const float* norms, float* g, void* dtiles,
        float* dtiles_n, float* dcc, float* dbq, float* dbk, float* dww,
        void* dq, void* dk, void* dv, float* dlf, float* dig, const Dims& d,
        cudaStream_t st) {
  const bf16 *qt = static_cast<const bf16*>(q), *kt = static_cast<const bf16*>(k);
  const bf16 *vt = static_cast<const bf16*>(v), *dot = static_cast<const bf16*>(dout);
  const bf16* ct = static_cast<const bf16*>(tiles);
  const long long rows = static_cast<long long>(d.BH) * d.T;
  const long long pgrid = (rows + kThreads / 32 - 1) / (kThreads / 32);
  gla_bwd_prep_kernel<bf16><<<static_cast<unsigned>(pgrid), kThreads, 0, st>>>(
      static_cast<const bf16*>(out), dot, norms, g, rows, d.dv, d.normalize);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ndk = (d.dk + 63) / 64, ndv = (d.dv + 63) / 64;
  const int s_smem = StateSmem<LP>::BYTES;
  err = cudaFuncSetAttribute(gla_tc_dstate_kernel<LP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gla_tc_dstate_kernel<LP><<<dim3(ndk, ndv, d.BH), kWg, s_smem, st>>>(
      qt, dot, lf, ig, norms, g, ct, tiles_n, static_cast<bf16*>(dtiles),
      dtiles_n, dcc, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int b_smem = BwdSmem<LP>::BYTES;
  const dim3 grid(d.nc * (LP / 64), d.BH);
  err = cudaFuncSetAttribute(gla_tc_bwd_key_kernel<LP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, b_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gla_tc_bwd_key_kernel<LP><<<grid, kWg, b_smem, st>>>(
      qt, kt, vt, dot, lf, ig, norms, g, static_cast<const bf16*>(dtiles),
      dtiles_n, static_cast<bf16*>(dk), static_cast<bf16*>(dv), dig, dbk, dww,
      d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(gla_tc_bwd_query_kernel<LP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, b_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gla_tc_bwd_query_kernel<LP><<<grid, kWg, b_smem, st>>>(
      qt, kt, vt, dot, lf, ig, norms, g, ct, tiles_n, static_cast<bf16*>(dq),
      dbq, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gla_tc_bwd_gates_kernel<<<dim3(d.nc, d.BH), kWg, 0, st>>>(
      lf, ig, dbq, dbk, dww, dcc, ndk * ndv, dlf, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// The f32 route (the bf16 route is gla_scan_tc_fwd_launch and
// gla_scan_tc_bwd_launch below).  q, k [BH, T, dk], v and out [BH, T, dv],
// log_f and i_gate [BH, T], state [BH, dk, dv+1], all f32; scores
// [BH, nc, L, L] f32 scratch.  states ([BH, nc, dk, dv+1]) and norms
// ([BH, T]) may be null; when given, the forward saves the state entering
// every chunk and every step's normalizer into them.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int gla_scan_fwd_launch(const float* q, const float* k,
                                   const float* v, const float* lf,
                                   const float* ig, float* out, float* state,
                                   float* scores, float* states, float* norms,
                                   int BH, int T, int dk, int dv, int L,
                                   int nc, int normalize, float scale,
                                   void* stream) {
  const Dims d{BH, T, dk, dv, L, nc, normalize, scale};
  if (!dims_ok(d) || (states == nullptr) != (norms == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (sizeof(float) * fwd_smem_floats(dk, L) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd(q, k, v, lf, ig, out, state, scores, states, norms, d,
                    static_cast<cudaStream_t>(stream));
}

// The backward: dq, dk, dv ([BH, T, d]), dlog_f and di_gate [BH, T], all
// f32.  scores, g ([BH, T]) and the partials (dq_part, dk_part [n_tiles,
// BH, T, dk]; dlf_part, dig_part [n_tiles, BH, T], n_tiles = ceil(dv / 32))
// are f32 scratch.
extern "C" int gla_scan_bwd_launch(
    const float* q, const float* k, const float* v, const float* lf,
    const float* ig, const float* out, const float* dout,
    const float* states, const float* norms, float* scores, float* g,
    float* dq_part, float* dk_part, float* dlf_part, float* dig_part,
    float* dq, float* dk, float* dv, float* dlf, float* dig, int BH, int T,
    int dk_, int dv_, int L, int nc, int normalize, float scale,
    void* stream) {
  const Dims d{BH, T, dk_, dv_, L, nc, normalize, scale};
  if (!dims_ok(d)) return static_cast<int>(cudaErrorInvalidValue);
  if (sizeof(float) * bwd_smem_floats(dk_, L) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd(q, k, v, lf, ig, out, dout, states, norms, scores, g,
                    dq_part, dk_part, dlf_part, dig_part, dq, dk, dv, dlf,
                    dig, d, static_cast<cudaStream_t>(stream));
}

// The bf16 route.  q, k [BH, T, dk], v and out [BH, T, dv] bf16, 16-byte
// aligned; log_f and i_gate [BH, T] f32; state [BH, dk, dv+1] f32; tiles
// (bf16, [BH, nc, ceil(dk/64), ceil(dv/64), 2, 64, 64]) and tiles_n (f32
// [BH, nc, dk]): the state entering every chunk as hi/lo panel pairs and
// its normalizer column (scratch, or kept for the backward); norms [BH, T]
// f32 or null (every step's normalizer, kept for the backward).  Returns
// the cudaError_t of the launches.
extern "C" int gla_scan_tc_fwd_launch(const void* q, const void* k,
                                      const void* v, const float* lf,
                                      const float* ig, void* out, float* state,
                                      void* tiles, float* tiles_n,
                                      float* norms, int BH, int T, int dk,
                                      int dv, int L, int nc, int normalize,
                                      float scale, void* stream) {
  const Dims d{BH, T, dk, dv, L, nc, normalize, scale};
  if (!dims_ok(d) || tiles == nullptr || tiles_n == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L <= 64)
    return tc::fwd<64>(q, k, v, lf, ig, out, state, tiles, tiles_n, norms, d, st);
  return tc::fwd<128>(q, k, v, lf, ig, out, state, tiles, tiles_n, norms, d, st);
}

// The bf16 backward: dq, dk, dv bf16 ([BH, T, d]), dlog_f and di_gate f32
// [BH, T].  tiles, tiles_n and norms are the forward's.  Scratch: dtiles
// and dtiles_n (dC leaving every chunk, laid out as tiles and tiles_n); g,
// dbq, dbk, dww f32 [BH, T]; dcc f32 [BH, nc, ceil(dk/64) ceil(dv/64)]
// (<dC, C> partials).  No [n_tiles, BH, T, dk] partials.
extern "C" int gla_scan_tc_bwd_launch(
    const void* q, const void* k, const void* v, const float* lf,
    const float* ig, const void* out, const void* dout, const void* tiles,
    const float* tiles_n, const float* norms, float* g, void* dtiles,
    float* dtiles_n, float* dcc, float* dbq, float* dbk, float* dww, void* dq,
    void* dk, void* dv, float* dlf, float* dig, int BH, int T, int dk_,
    int dv_, int L, int nc, int normalize, float scale, void* stream) {
  const Dims d{BH, T, dk_, dv_, L, nc, normalize, scale};
  if (!dims_ok(d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L <= 64)
    return tc::bwd<64>(q, k, v, lf, ig, out, dout, tiles, tiles_n, norms, g,
                       dtiles, dtiles_n, dcc, dbq, dbk, dww, dq, dk, dv, dlf,
                       dig, d, st);
  return tc::bwd<128>(q, k, v, lf, ig, out, dout, tiles, tiles_n, norms, g,
                      dtiles, dtiles_n, dcc, dbq, dbk, dww, dq, dk, dv, dlf,
                      dig, d, st);
}
