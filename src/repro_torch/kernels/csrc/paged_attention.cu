// Paged decode attention for Hopper (sm_90a), one query row per sequence,
// read in place off a paged K/V pool through a page table.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py:131
// (paged_attention, body _paged_kernel).  It computes the same function:
//
//   s_j   = dot(k_j, q) * (k_scale * sm_scale)      slot j of a page
//   masked slots (slot >= length) score -1e30 and get probability +0.0
//   softmax over the row's visible slots; values (p . v) * v_scale per page
//   out   = acc / max(l, 1e-30)                      (length 0 -> exact 0)
//
// What bounds it on this card: the bytes of K/V pages it reads.  Per
// (row, head) it touches 2 * length * d elements and does ~4 flops per
// element (x group in GQA), far below the ~20 flops/byte the f32 units need
// to be the limit, so the kernel is memory-bound at every tier.  At the
// decode shape (a few rows of a few dozen tokens) a launch and one round of
// dependent loads (table, then pages) set its time; at long contexts the
// bytes do, and the card needs many blocks, each with loads in flight.
//
// Design.  The TPU kernel walks a (row, head, page) grid in order and keeps
// the online-softmax state in VMEM across grid steps; here:
//   * a row's tokens are cut into splits of `split` tokens (kSplitTokens,
//     rounded to whole chunks), and each split is a block of its own, so a
//     long row spreads over many SMs.  The grid's split axis is sized from
//     npm * ps; a block past its row's own ceil(length / split) splits
//     exits at once.  A row of one split (and a row of length 0) is
//     finished by its block; the splits of a longer row leave (m, l, acc)
//     partials that a merge kernel combines in split order: rescale to the
//     common max, sum, divide.  The number of splits and the arithmetic of
//     each depend on the row's own length only, never on npm or B, so pad
//     columns that add a merge launch change no bit;
//   * in plain GQA (no head maps) one block serves `group` q heads of one
//     kv head and reads each K/V row once for all of them; with explicit
//     maps (kv_head, page_offset: the stacked pool of every rank) a block
//     serves one head.  Each head's arithmetic is the same either way;
//   * a block walks its split in chunks of whole pages (kChunkBytes of K
//     and V, at most kMaxChunk tokens: 32 tokens of f32 at d = dv = 128, 64
//     of bf16, 128 of int8 or e4m3), each page through its own table entry.
//     cp.async (16 bytes a copy where the rows allow, else 8 or 4) fills a
//     ring of kStages chunks in shared memory: the next chunks' loads are
//     in flight while this chunk's scores and p . v run, one barrier a
//     chunk.  The split's page ids and scales are read once, at the start;
//   * each of the 8 warps keeps its own online softmax over its eighth of
//     every chunk's slots, one update a chunk, with no barrier between
//     warps: a slot's score (for every head of the block) is each lane's
//     sum over its own slices of 4 columns in order, then a butterfly of
//     shuffles, which leaves it in every lane; lane t keeps slot t's
//     probability.  k_scale * sm_scale multiplies each slot's score;
//     v_scale multiplies each page's p . v part before it joins acc, as in
//     the reference.  At the end the 8 warps' (m, l, acc) are combined in
//     warp order.  So a (row, head)'s bits depend only on its q, its length
//     and its pages' contents: not on B, Hq, npm, the pool position of the
//     pages, the grouping of heads or the SM count;
//   * pages are stored as f32, bf16, int8 or e4m3 and converted to f32 on
//     their way out of shared memory; every score, probability and sum is
//     f32.  Slots past the length are neither read nor summed.
// It uses CUDA cores only: ~1 flop a byte gives the tensor cores nothing to
// do.  Built without fast math: expf is the accurate one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplitTokens = 256;    // tokens of a split (whole chunks)
constexpr int kChunkBytes = 32768;   // K and V bytes of a chunk, one head
constexpr int kStages = 3;           // chunks in the ring (>= 2)
constexpr int kMaxChunk = 128;       // tokens of a chunk, at most
constexpr int kMaxD = 256;           // q/k width: two 4-column slices a lane
constexpr int kMaxSmem = 232448;     // a block's shared memory on Hopper
constexpr float kNegInf = -1e30f;

// The chunk and split of a call (tokens), from its page size, widths and
// storage bytes alone; kernels/paged_attention.py's plan() is the same.
struct Plan {
  int chunk, split;
};
inline Plan make_plan(int ps, int d, int dv, int elem) {
  int pages = kChunkBytes / ((d + dv) * elem * ps);
  if (pages > kMaxChunk / ps) pages = kMaxChunk / ps;
  if (pages < 1) pages = 1;
  const int chunk = pages * ps;
  const int chunks = kSplitTokens / chunk > 1 ? kSplitTokens / chunk : 1;
  return {chunk, chunks * chunk};
}

// bytes of one asynchronous copy: the largest of 16, 8, 4 that divides a
// K row and a V row (the rows' widths are multiples of 4)
__host__ __device__ inline int copy_bytes(int d, int dv, int elem) {
  const int rows = (d * elem) | (dv * elem);
  return rows % 16 == 0 ? 16 : rows % 8 == 0 ? 8 : 4;
}

// the ring (after the loop, the warps' states for their combine), rounded
// to 16 bytes
__host__ __device__ inline size_t ring_bytes(const Plan& p, int d, int dv,
                                              int elem, int group) {
  const size_t ring = kStages * static_cast<size_t>(p.chunk) * (d + dv) * elem;
  const size_t comb = static_cast<size_t>(kWarps) * group * (dv + 2) * 4;
  return ((ring > comb ? ring : comb) + 15) / 16 * 16;
}

// shared memory of a block: the ring, q, the split's page ids and scales
inline size_t smem_bytes(const Plan& p, int ps, int d, int dv, int elem,
                         int group) {
  return ring_bytes(p, d, dv, elem, group) +
         4 * static_cast<size_t>(group) * d +
         12 * static_cast<size_t>(p.split / ps);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// four consecutive elements of shared memory as f32
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}
template <typename T>
__device__ __forceinline__ void load4(const T* p, float* x) {  // 1-byte types
  const uint32_t t = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T e;
    *reinterpret_cast<uint8_t*>(&e) = static_cast<uint8_t>(t >> (8 * i));
    x[i] = to_f32(e);
  }
}

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

// tokens of a row the kernel sees: its length, clamped to its pages
__device__ __forceinline__ int row_tokens(const int* lengths, int b, int npm,
                                          int ps) {
  const int n = lengths[b];
  return n < 0 ? 0 : n > npm * ps ? npm * ps : n;
}

// `bytes` (16, 8 or 4; uniform over the block) from global to shared
// memory, asynchronously; zeros where `valid` is false (src is then not
// read)
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           bool valid, int bytes) {
  if (bytes == 16) {
    tc::cp_async16(dst, src, valid);
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     tc::smem_u32(dst)), "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     tc::smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

// rows [t0, t0 + chunk) of a split's K (or V) pages, w columns each, into
// shared memory at dst, `bytes` a copy (cp.async); rows from `rows` on
// zero-fill and are not read.  Row j lies in page pid[(t0 + j) / ps], slot
// (t0 + j) % ps, kv head hk
template <typename T>
__device__ __forceinline__ void issue_chunk(const T* __restrict__ pool,
                                            const int* pid, int hk, int Hkv,
                                            int ps, int w, int t0, int rows,
                                            uint8_t* dst, int tid, int chunk,
                                            int bytes) {
  const int units = w * static_cast<int>(sizeof(T)) / bytes;  // copies a row
  const int step = bytes / static_cast<int>(sizeof(T));       // elements
  for (int u = tid; u < chunk * units; u += kThreads) {
    const int j = u / units, c = u - j * units;
    const bool ok = j < rows;
    const T* src = pool;
    if (ok) {
      const int pg = (t0 + j) / ps, slot = t0 + j - pg * ps;
      src = pool + ((static_cast<int64_t>(pid[pg]) * ps + slot) * Hkv + hk) * w +
            c * step;
    }
    cp_async_n(dst + bytes * u, src, ok, bytes);
  }
}

// output columns a lane holds for each of a block's G heads: lane l holds
// columns l, l + 32, ... of dv (so dv <= 32 * kCols<G>)
template <int G>
constexpr int kCols = G <= 2 ? 16 : 32 / G;

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const float* __restrict__ q,        // [B, Hq, d]
                   const T* __restrict__ k_pages,      // [n_pages, ps, Hkv, d]
                   const T* __restrict__ v_pages,      // [n_pages, ps, Hkv, dv]
                   const int* __restrict__ table,      // [B, npm]
                   const int* __restrict__ lengths,    // [B]
                   const float* __restrict__ k_scale,  // [n_pages, Hkv]
                   const float* __restrict__ v_scale,  // [n_pages, Hkv]
                   const int* __restrict__ kv_head,    // [Hq]
                   const int* __restrict__ page_offset,  // [Hq]
                   float* __restrict__ out,            // [B, Hq, dv]
                   float* __restrict__ part_m,         // [B, Hq, n_splits]
                   float* __restrict__ part_l,         // [B, Hq, n_splits]
                   float* __restrict__ part_acc,       // [B, Hq, n_splits, dv]
                   int Hq, int d, int dv, int ps, int Hkv, int npm,
                   int n_splits, Plan plan, float sm_scale) {
  constexpr int NC = kCols<G>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int s = blockIdx.x, h0 = blockIdx.y * G, b = blockIdx.z;
  const int n = row_tokens(lengths, b, npm, ps);
  const int ns = n > 0 ? (n + plan.split - 1) / plan.split : 1;
  if (s >= ns) return;  // past the row's own splits
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = plan.chunk;
  const int qw = (chunk + kWarps - 1) / kWarps;        // a warp's slots
  const int tb = s * plan.split;                       // the split's tokens
  const int nt = (n < tb + plan.split ? n : tb + plan.split) - tb;  // (>= 0)
  const int pb = tb / ps, npg = (nt + ps - 1) / ps;    // and pages
  const int hk = kv_head[h0], poff = page_offset[h0];

  const size_t stage = static_cast<size_t>(chunk) * (d + dv) * sizeof(T);
  const int bytes = copy_bytes(d, dv, sizeof(T));
  float* q_s = reinterpret_cast<float*>(smem + ring_bytes(plan, d, dv,
                                                          sizeof(T), G));
  int* pid_s = reinterpret_cast<int*>(q_s + G * d);   // [split / ps] each:
  float* ksf_s = reinterpret_cast<float*>(pid_s + plan.split / ps);
  float* vs_s = ksf_s + plan.split / ps;

  const float* qb = q + (static_cast<int64_t>(b) * Hq + h0) * d;
  for (int i = tid; i < G * d; i += kThreads) q_s[i] = qb[i];
  for (int i = tid; i < npg; i += kThreads) {
    const int pid = table[static_cast<int64_t>(b) * npm + pb + i] + poff;
    const int64_t si = static_cast<int64_t>(pid) * Hkv + hk;
    pid_s[i] = pid;
    ksf_s[i] = k_scale[si] * sm_scale;
    vs_s[i] = v_scale[si];
  }
  __syncthreads();

  // each warp's own online softmax over its slots of every chunk: state
  // (m, l) per head, held alike by every lane, and acc per head over the
  // lane's columns
  float m[G], l[G], acc[G][NC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[g][c] = 0.f;
  }

  const size_t v_off = static_cast<size_t>(chunk) * d * sizeof(T);
  const int nc = (nt + chunk - 1) / chunk;
  // chunk c into ring stage c % kStages: the first kStages - 1 before the
  // loop, chunk c + kStages - 1 at step c, right after the barrier that
  // frees its stage.  Every issue commits one group (empty past the last
  // chunk), so at step c all but the newest kStages - 2 groups hold chunk c
  auto issue = [&](int c) {
    if (c < nc) {
      const int t0 = c * chunk, rows = min(chunk, nt - t0);
      uint8_t* st = smem + (c % kStages) * stage;
      issue_chunk(k_pages, pid_s, hk, Hkv, ps, d, t0, rows, st, tid, chunk,
                  bytes);
      issue_chunk(v_pages, pid_s, hk, Hkv, ps, dv, t0, rows, st + v_off, tid,
                  chunk, bytes);
    }
    tc::cp_async_commit();
  };
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  for (int c = 0; c < nc; ++c) {
    tc::cp_async_wait<kStages - 2>();
    // chunk c has landed for every thread, and every warp is done with
    // chunk c - 1, whose stage the next issue refills
    __syncthreads();
    issue(c + kStages - 1);
    const T* kc = reinterpret_cast<const T*>(smem + (c % kStages) * stage);
    const T* vc = kc + static_cast<size_t>(chunk) * d;
    const int t0 = c * chunk;                          // of the split
    const int rows = nt - t0 < chunk ? nt - t0 : chunk;
    const int w0 = warp * qw;                          // the warp's slots
    const int nw = rows - w0 < qw ? rows - w0 : qw;    // (may be <= 0)
    if (nw <= 0) continue;

    // scores: lane sums its 4-column slices of q . k in order, then the
    // butterfly; lane t keeps slot t's, every lane the running max
    float mine[G], mx[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mine[g] = kNegInf;
      mx[g] = m[g];
    }
#pragma unroll 4
    for (int t = 0; t < nw; ++t) {
      float kx[8];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = 4 * lane + 128 * r;
        if (e < d) {
          load4(kc + static_cast<size_t>(w0 + t) * d + e, kx + 4 * r);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) kx[4 * r + i] = 0.f;
        }
      }
      const float f = ksf_s[(t0 + w0 + t) / ps];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 4 * lane + 128 * r;
          if (e < d) {
            const float4 w = *reinterpret_cast<const float4*>(q_s + g * d + e);
            a += kx[4 * r] * w.x;
            a += kx[4 * r + 1] * w.y;
            a += kx[4 * r + 2] * w.z;
            a += kx[4 * r + 3] * w.w;
          }
        }
        a = warp_sum(a) * f;
        if (lane == t) mine[g] = a;
        mx[g] = fmaxf(mx[g], a);
      }
    }
    // the warp's online-softmax update over its slots of the chunk
    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float alpha = expf(m[g] - mx[g]);
      p[g] = lane < nw ? expf(mine[g] - mx[g]) : 0.f;
      l[g] = l[g] * alpha + warp_sum(p[g]);
      m[g] = mx[g];
#pragma unroll
      for (int c2 = 0; c2 < NC; ++c2) acc[g][c2] *= alpha;
    }
    // p . v: each page's part, times its v_scale, joins acc in page order
    float part[G][NC];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c2 = 0; c2 < NC; ++c2) part[g][c2] = 0.f;
#pragma unroll 4
    for (int t = 0; t < nw; ++t) {
      const T* vr = vc + static_cast<size_t>(w0 + t) * dv;
      float vx[NC];
#pragma unroll
      for (int c2 = 0; c2 < NC; ++c2)
        vx[c2] = lane + 32 * c2 < dv ? to_f32(vr[lane + 32 * c2]) : 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pt = __shfl_sync(0xffffffffu, p[g], t);
#pragma unroll
        for (int c2 = 0; c2 < NC; ++c2) part[g][c2] += pt * vx[c2];
      }
      const int tok = t0 + w0 + t;
      if (t == nw - 1 || (tok + 1) % ps == 0) {
        const float vs = vs_s[tok / ps];
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int c2 = 0; c2 < NC; ++c2) {
            acc[g][c2] += part[g][c2] * vs;
            part[g][c2] = 0.f;
          }
      }
    }
  }

  // the warps' states, combined in warp order: rescale to the common max,
  // sum (a warp that saw no slot holds m = -1e30, l = 0, acc = 0)
  __syncthreads();  // the ring is done with; the combine reuses it
  float* cm = reinterpret_cast<float*>(smem);          // [warp][G]
  float* cl = cm + kWarps * G;                         // [warp][G]
  float* ca = cl + kWarps * G;                         // [warp][G][dv]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      cm[warp * G + g] = m[g];
      cl[warp * G + g] = l[g];
    }
#pragma unroll
    for (int c2 = 0; c2 < NC; ++c2)
      if (lane + 32 * c2 < dv)
        ca[(warp * G + g) * dv + lane + 32 * c2] = acc[g][c2];
  }
  __syncthreads();
  const int64_t row0 = static_cast<int64_t>(b) * Hq + h0;
  for (int idx = tid; idx < G * dv; idx += kThreads) {
    const int g = idx / dv, i = idx - g * dv;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, cm[w * G + g]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(cm[w * G + g] - mx);
      lt += cl[w * G + g] * f;
      at += ca[(w * G + g) * dv + i] * f;
    }
    if (ns == 1) {
      out[(row0 + g) * dv + i] = at / fmaxf(lt, 1e-30f);
    } else {
      part_acc[((row0 + g) * n_splits + s) * dv + i] = at;
      if (i == 0) {
        part_m[(row0 + g) * n_splits + s] = mx;
        part_l[(row0 + g) * n_splits + s] = lt;
      }
    }
  }
}

// the splits of a row of more than one: rescale each to the common max,
// sum in split order, divide; rows of one split are final already
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const float* __restrict__ part_m,
                   const float* __restrict__ part_l,
                   const float* __restrict__ part_acc,
                   const int* __restrict__ lengths, float* __restrict__ out,
                   int Hq, int dv, int ps, int npm, int n_splits, int split) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int n = row_tokens(lengths, b, npm, ps);
  const int ns = (n + split - 1) / split;
  if (ns <= 1) return;
  const int64_t base = (static_cast<int64_t>(b) * Hq + h) * n_splits;
  float mx = kNegInf;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, part_m[base + s]);
  float l = 0.f;
  for (int s = 0; s < ns; ++s) l += part_l[base + s] * expf(part_m[base + s] - mx);
  const float den = fmaxf(l, 1e-30f);
  for (int i = threadIdx.x; i < dv; i += kThreads) {
    float a = 0.f;
    for (int s = 0; s < ns; ++s)
      a += part_acc[(base + s) * dv + i] * expf(part_m[base + s] - mx);
    out[(static_cast<int64_t>(b) * Hq + h) * dv + i] = a / den;
  }
}

// Raise the split kernel's dynamic shared-memory limit to the block's
// whole share, once for each device (bit i: device i is set)
template <typename K>
cudaError_t allow_smem(K kernel, std::atomic<uint64_t>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done->load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess) done->fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <typename T, int G>
cudaError_t launch_g(const float* q, const void* k, const void* v,
                     const int* table, const int* lengths, const float* ks,
                     const float* vs, const int* kv_head,
                     const int* page_offset, float* out, float* part_m,
                     float* part_l, float* part_acc, int B, int Hq, int d,
                     int dv, int ps, int Hkv, int npm, int n_splits,
                     const Plan& plan, float sm_scale, cudaStream_t stream) {
  if (dv > 32 * kCols<G>) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(plan, ps, d, dv, sizeof(T), G);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = allow_smem(paged_split_kernel<T, G>, &smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_splits, Hq / G, B);
  paged_split_kernel<T, G><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), table, lengths, ks,
      vs, kv_head, page_offset, out, part_m, part_l, part_acc, Hq, d, dv, ps,
      Hkv, npm, n_splits, plan, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  paged_merge_kernel<<<dim3(Hq, B), kThreads, 0, stream>>>(
      part_m, part_l, part_acc, lengths, out, Hq, dv, ps, npm, n_splits,
      plan.split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const int* table, const int* lengths, const float* ks,
                   const float* vs, const int* kv_head, const int* page_offset,
                   float* out, float* part_m, float* part_l, float* part_acc,
                   int B, int Hq, int d, int dv, int ps, int Hkv, int npm,
                   int group, int n_splits, const Plan& plan, float sm_scale,
                   cudaStream_t stream) {
#define PA_G(G)                                                               \
  launch_g<T, G>(q, k, v, table, lengths, ks, vs, kv_head, page_offset, out,  \
                 part_m, part_l, part_acc, B, Hq, d, dv, ps, Hkv, npm,        \
                 n_splits, plan, sm_scale, stream)
  switch (group) {
    case 1: return PA_G(1);
    case 2: return PA_G(2);
    case 4: return PA_G(4);
    case 8: return PA_G(8);
    default: return cudaErrorInvalidValue;
  }
#undef PA_G
}

constexpr int kElem[4] = {4, 2, 1, 1};  // bytes of a stored element

}  // namespace

// The plan of a call: out[0] = tokens of a chunk, out[1] = tokens of a
// split, out[2] = the split kernel's shared memory in bytes at `group`
// heads a block.  Returns 0, or cudaErrorInvalidValue for a storage code
// not in 0..3.
extern "C" int paged_attention_plan(int ps, int d, int dv, int storage,
                                    int group, int* out) {
  if (storage < 0 || storage > 3 || ps < 1 || d < 1 || dv < 1 || group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(ps, d, dv, kElem[storage]);
  out[0] = p.chunk;
  out[1] = p.split;
  out[2] = static_cast<int>(smem_bytes(p, ps, d, dv, kElem[storage], group));
  return 0;
}

// Storage codes: 0 = f32, 1 = bf16, 2 = int8, 3 = e4m3.  `group` (1, 2, 4
// or 8, with dv <= 32 * kCols<group>) q heads share a block (they must
// share their kv head and page offset); the grid
// has n_splits = ceil(npm * ps / split) splits a row, and the partials
// [B, Hq, n_splits] (m, l) and [B, Hq, n_splits, dv] (acc) are scratch the
// caller allocates when n_splits > 1.  `split` is the caller's copy of the
// plan, checked against this one.  Returns the cudaError_t of the launches
// (0 on success); shapes are checked by the caller.
extern "C" int paged_attention_launch(
    const float* q, const void* k_pages, const void* v_pages, const int* table,
    const int* lengths, const float* k_scale, const float* v_scale,
    const int* kv_head, const int* page_offset, float* out, float* part_m,
    float* part_l, float* part_acc, int B, int Hq, int d, int dv, int ps,
    int Hkv, int npm, int group, int n_splits, int split, float sm_scale,
    int storage, void* stream) {
  if (storage < 0 || storage > 3 || d < 4 || d > kMaxD || d % 4 ||
      dv < 4 || dv % 4 || ps < 1 || group < 1 || Hq % group ||
      n_splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = make_plan(ps, d, dv, kElem[storage]);
  if (plan.split != split || plan.chunk > kMaxChunk ||
      static_cast<int64_t>(n_splits) * split < static_cast<int64_t>(npm) * ps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_LAUNCH(T)                                                           \
  launch<T>(q, k_pages, v_pages, table, lengths, k_scale, v_scale, kv_head,    \
            page_offset, out, part_m, part_l, part_acc, B, Hq, d, dv, ps, Hkv, \
            npm, group, n_splits, plan, sm_scale, s)
  switch (storage) {
    case 0: return static_cast<int>(PA_LAUNCH(float));
    case 1: return static_cast<int>(PA_LAUNCH(__nv_bfloat16));
    case 2: return static_cast<int>(PA_LAUNCH(int8_t));
    default: return static_cast<int>(PA_LAUNCH(__nv_fp8_e4m3));
  }
#undef PA_LAUNCH
}
