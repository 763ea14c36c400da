// K4: single-launch chunked monoid scans for Hopper (sm_90a) — the mLSTM
// log-space carry (tree layout) and Mamba's affine recurrence (batched
// layout).  K5 (tile_scan_add, the int32 sum the stable sort needs) is at
// the end of the file.
//
// Replaces: repro/kernels/tile_scan.py::_tree_scan_call (body
// _tree_scan_kernel) as reached from tree_scan with
// ssm_scan.logspace_affine_combine (mlstm_carry_scan, every chunk-parallel
// mLSTM prefill) and from batched_scan with ssm_scan.affine_combine
// (mamba_assoc_scan, every Mamba chunk under scan_impl="pallas").
//
// What bounds it on this card: both scans do a handful of flops per element
// (two multiplies and an add) on fp32 data that is read once and written
// once, far below the ~20 flops/byte (67 TFLOP/s over 3.35 TB/s) at which
// fp32 CUDA cores would be the limit.  So the kernels are bound by bytes: the least time is the leaves'
// bytes (read once) plus the outputs' bytes (written once) over 3.35 TB/s,
// and the design goal is coalesced 16-byte accesses with several in flight.
//
// The TPU kernel carries the running fold in VMEM scratch across its
// sequential grid axis.  A Hopper grid runs in no order, so nothing carries
// between CTAs here: the scan axis (chunks for mLSTM, time for Mamba) is a
// loop inside each thread, and the CTAs split the independent columns.
//
// Design, logspace (tile_scan_logspace): elements (la, m, C, n) with la, m
// of shape (L, G) and C (L, G, FC), n (L, G, FN) (G = batch x heads; FC =
// dh*dh, FN = dh), combined as
//   m' = max(m1 + la2, m2),  s1 = exp(m1 + la2 - m'),  s2 = exp(m2 - m'),
//   (C, n)' = s1 * (C1, n1) + s2 * (C2, n2),  la' = la1 + la2.
// The scales depend only on the per-(g) scalar chain, never on C or n.  One
// CTA per (column tile, g): its threads stage la and m of the L elements in
// shared memory, one thread folds the scalar chain from the seed (la0, m0)
// and leaves s1[k], s2[k] there (the CTA of column tile 0 also writes the
// scanned la and m), then every thread walks its 4 float4 columns of C (or
// n) down the L elements: out = s1*carry + s2*x, each product and the sum
// rounded on its own as the plain twin rounds them.  Exclusive output k is
// the carry entering element k; inclusive is the carry after it.
//
// Design, affine (tile_scan_affine): elements (a, b) of shape (B, L, F),
// combined as (a1*a2, b2 + a2*b1), seeded with (a0, h0) of shape (B, F).
// One thread per (row, 4 columns) walks L with the loop unrolled 4 deep so
// the loads of later steps are in flight while earlier ones combine.  The
// gain leaf is written only if its output pointer is not null:
// mamba_assoc_scan needs the states alone.
#include "common.cuh"

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;                   // float4 columns a thread owns
constexpr int TILE = THREADS * 4 * VEC;  // floats of one leaf per CTA
constexpr int MAX_L = 2048;              // logspace scan length (smem chain)

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
// s1*c + s2*x without contraction into an FMA: the plain twin's rounding
__device__ __forceinline__ float mix(float s1, float c, float s2, float x) {
  return __fadd_rn(__fmul_rn(s1, c), __fmul_rn(s2, x));
}
__device__ __forceinline__ float4 mix(float s1, const float4& c, float s2,
                                      const float4& x) {
  return make_float4(mix(s1, c.x, s2, x.x), mix(s1, c.y, s2, x.y),
                     mix(s1, c.z, s2, x.z), mix(s1, c.w, s2, x.w));
}
__device__ __forceinline__ float4 mul4(const float4& a, const float4& b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                     __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
}
// b + a*h, rounded as the twin's `b2 + a2 * b1`
__device__ __forceinline__ float4 affine4(const float4& a, const float4& h,
                                          const float4& b) {
  return make_float4(__fadd_rn(b.x, __fmul_rn(a.x, h.x)),
                     __fadd_rn(b.y, __fmul_rn(a.y, h.y)),
                     __fadd_rn(b.z, __fmul_rn(a.z, h.z)),
                     __fadd_rn(b.w, __fmul_rn(a.w, h.w)));
}

__global__ void __launch_bounds__(THREADS)
logspace_scan_kernel(const float* __restrict__ la, const float* __restrict__ ms,
                     const float* __restrict__ C, const float* __restrict__ n,
                     const float* __restrict__ la0,
                     const float* __restrict__ m0,
                     const float* __restrict__ C0,
                     const float* __restrict__ n0, float* __restrict__ la_out,
                     float* __restrict__ m_out, float* __restrict__ C_out,
                     float* __restrict__ n_out, int L, int G, int FC, int FN,
                     int tilesC, int inclusive) {
  extern __shared__ float chain[];  // la then s1 [L], m then s2 [L]
  float* s1 = chain;
  float* s2 = chain + L;
  const int g = blockIdx.y, tile = blockIdx.x;

  for (int k = threadIdx.x; k < L; k += THREADS) {
    s1[k] = la[(size_t)k * G + g];
    s2[k] = ms[(size_t)k * G + g];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float lac = la0[g], mc = m0[g];
    const bool scalars = tile == 0;
    for (int k = 0; k < L; ++k) {
      const size_t i = (size_t)k * G + g;
      const float lak = s1[k], mk = s2[k];
      const float mn = fmaxf(mc + lak, mk);
      s1[k] = expf(mc + lak - mn);
      s2[k] = expf(mk - mn);
      if (scalars && !inclusive) { la_out[i] = lac; m_out[i] = mc; }
      lac = lac + lak;
      mc = mn;
      if (scalars && inclusive) { la_out[i] = lac; m_out[i] = mc; }
    }
  }
  __syncthreads();

  const float* X = C;
  const float* X0 = C0;
  float* Y = C_out;
  int F = FC, t = tile;
  if (tile >= tilesC) {
    X = n; X0 = n0; Y = n_out; F = FN; t = tile - tilesC;
  }
  const int col0 = t * TILE + threadIdx.x * 4;
  float4 c[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int col = col0 + v * THREADS * 4;
    if (col < F) c[v] = ld4(X0 + (size_t)g * F + col);
  }
  for (int k = 0; k < L; ++k) {
    const size_t row = ((size_t)k * G + g) * F;
    float4 x[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int col = col0 + v * THREADS * 4;
      if (col < F) x[v] = ld4(X + row + col);
    }
    const float a = s1[k], b = s2[k];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int col = col0 + v * THREADS * 4;
      if (col < F) {
        if (!inclusive) st4(Y + row + col, c[v]);
        c[v] = mix(a, c[v], b, x[v]);
        if (inclusive) st4(Y + row + col, c[v]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
affine_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ a0, const float* __restrict__ h0,
                   float* __restrict__ gain_out, float* __restrict__ h_out,
                   int L, int F, int inclusive) {
  const int row = blockIdx.y;
  const int col = (blockIdx.x * THREADS + threadIdx.x) * 4;
  if (col >= F) return;
  float4 ca = ld4(a0 + (size_t)row * F + col);
  float4 ch = ld4(h0 + (size_t)row * F + col);
  const size_t base = (size_t)row * L * F + col;
#pragma unroll 4
  for (int t = 0; t < L; ++t) {
    const size_t i = base + (size_t)t * F;
    const float4 at = ld4(a + i), bt = ld4(b + i);
    if (!inclusive) {
      if (gain_out != nullptr) st4(gain_out + i, ca);
      st4(h_out + i, ch);
    }
    ca = mul4(ca, at);
    ch = affine4(at, ch, bt);
    if (inclusive) {
      if (gain_out != nullptr) st4(gain_out + i, ca);
      st4(h_out + i, ch);
    }
  }
}

// K5: the int32 sum scan with a carry, one launch over a thread-block
// cluster.
//
// Replaces: repro/kernels/tile_scan.py::tile_scan (body _scan_kernel) and
// histogram_offsets, which scans the (nt, R) digit histogram digit-major
// for the multi-tile radix sort.  The TPU kernel carries the sum of earlier
// blocks in a (1, 1) VMEM cell across its sequential grid: one launch,
// whatever n.
//
// What bounds it on this card: bytes, each word read once and written once
// (2 MB at the sort path's largest histogram, 16384 x 16: 0.6 us at
// 3.35 TB/s), and at the path's usual sizes (64 KB) the latency of one
// launch.  v1 carried the TPU's sequential grid over literally: one CTA
// looped over the array with the carry, staging slabs in shared memory
// behind seven barriers each, so one SM made every access: 156x the bound
// at 16384 x 16.
//
// Design (v2): reduce, then scan, in one cluster of C <= 16 CTAs of 1024
// threads (cudaLaunchKernelEx with a cluster dimension; C above 8 is
// non-portable; the rule takes a CTA per 4096 words).  CTA c owns a
// contiguous block of rows, a multiple of 4 words, in chunks of 16 words a
// thread kept in registers.  For r >= 16 thread t holds digit t % r of 16
// consecutive rows, so a warp's access is runs of r words, a thread's
// words are one digit in index order, and the cross-thread scan is one
// shuffle step (r = 16) or none; for r < 16 (the 1-D scan) thread t holds
// words [16t, 16t + 16) as four int4s and scans r digits.  A template on
// log2(r) unrolls every loop.
//  1. Column sums.  A block of one chunk (every block of the sort path) is
//     scanned at once: a shuffle scan over the threads of one digit in a
//     warp (or a group of r threads), the rows' totals to shared memory,
//     thread d scans digit d over the rows; two barriers.  A longer block
//     sums its chunks first (shared atomics of warp-folded sums: integer
//     counts, order-free and exact).
//  2. Each CTA writes its column sums into every CTA's shared memory
//     (distributed shared memory stores: no round trip), then one cluster
//     barrier; every CTA then reads them locally: digit d's base is the sum
//     of the columns of smaller digits, and the carry entering block c adds
//     digit d's column over blocks before c.  A relaxed cluster arrive at
//     the start, waited on just before those stores, makes sure every CTA
//     has started; after the barrier no CTA touches another's memory.
//  3. Each thread writes carry + earlier rows + earlier threads + its own
//     earlier words from registers; a longer block loads and scans chunk by
//     chunk, the carry crossing chunks.
// No global scratch and no global atomics; the result is exact and the
// same every run.  Sums wrap as int32 does.
constexpr int SCAN_THREADS = 1024;
constexpr int CHUNK = SCAN_THREADS * 16;   // words: 16 a thread
constexpr int MAX_CLUSTER = 16;
// the cluster rule's least words a CTA: below it another CTA adds more
// barrier latency than it saves in loads (4096 was best at 1024 x 16)
constexpr int MIN_CTA_WORDS = 4096;

// How a CTA's 1024 threads hold a chunk of 16384 words of an (rows, 2^LR)
// matrix.  r < 16 (BLOCKED): thread t holds words [16t, 16t + 16), digits
// j % r, read as four int4s.  r >= 16: thread t holds digit t % r of the
// 16 rows from 16 (t / r), so a warp's access j is r-word runs of rows.
// Either way a thread's words run in index order, threads with one digit
// follow each other in index order P lanes apart, and the cross-thread
// scan runs over U rows of ROW threads (a warp, or a group of r threads).
template <int LR>
struct ScanShape {
  static constexpr int R = 1 << LR;
  static constexpr bool BLOCKED = R < 16;
  static constexpr int KC = BLOCKED ? R : 1;      // digits a thread holds
  static constexpr int P = BLOCKED ? 1 : (R < 32 ? R : 32);
  static constexpr int ROW = R > 32 ? R : 32;
  static constexpr int U = SCAN_THREADS / ROW;
};

// cluster barrier halves: arrive (relaxed: it orders nothing; release:
// this thread's earlier writes, remote ones included, are seen by every
// thread that has waited) and wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int LR>
__device__ __forceinline__ int word_of(int t, int j) {
  using S = ScanShape<LR>;
  return S::BLOCKED ? 16 * t + j
                    : (((t >> LR) * 16 + j) << LR) | (t & (S::R - 1));
}

template <int LR>
__device__ __forceinline__ int digit_of(int t, int k) {
  using S = ScanShape<LR>;
  return S::BLOCKED ? k : t & (S::R - 1);
}

// the thread's 16 words of the chunk at p, 0 at or past limit; int4 loads
// (BLOCKED, p 16-byte aligned: vec) where all four lie inside
template <int LR>
__device__ __forceinline__ void load16(const int* p, int limit, bool vec,
                                       unsigned (&w)[16]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int b = word_of<LR>(t, 4 * q);
    if (ScanShape<LR>::BLOCKED && vec && b + 4 <= limit) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p + b));
      w[4 * q] = (unsigned)v.x;
      w[4 * q + 1] = (unsigned)v.y;
      w[4 * q + 2] = (unsigned)v.z;
      w[4 * q + 3] = (unsigned)v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = word_of<LR>(t, 4 * q + e);
        w[4 * q + e] = i < limit ? (unsigned)__ldg(p + i) : 0u;
      }
    }
  }
}

template <int LR>
__device__ __forceinline__ void store16(int* p, int limit, bool vec,
                                        const unsigned (&w)[16]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int b = word_of<LR>(t, 4 * q);
    if (ScanShape<LR>::BLOCKED && vec && b + 4 <= limit) {
      *reinterpret_cast<int4*>(p + b) =
          make_int4((int)w[4 * q], (int)w[4 * q + 1], (int)w[4 * q + 2],
                    (int)w[4 * q + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = word_of<LR>(t, 4 * q + e);
        if (i < limit) p[i] = (int)w[4 * q + e];
      }
    }
  }
}

// The scan of one chunk, its carry left out.  On return excl[k] is the
// sum of the thread's k-th digit over the earlier threads of its scan row
// (a shuffle scan of stride P), wt[u * r + d] the sum of digit d over
// earlier rows u, and ctot[d] the chunk's column sum.  Two CTA barriers.
template <int LR>
__device__ __forceinline__ void chunk_scan(const unsigned (&w)[16],
                                           unsigned (&excl)[16],
                                           unsigned* wt, unsigned* ctot) {
  using S = ScanShape<LR>;
  const int t = threadIdx.x, lane = t & 31, u = t / S::ROW;
#pragma unroll
  for (int k = 0; k < S::KC; ++k) {
    unsigned a = 0u;
#pragma unroll
    for (int j = k; j < 16; j += S::KC) a += w[j];
    unsigned x = a;
#pragma unroll
    for (int o = S::P; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    excl[k] = x - a;
    if (lane >= 32 - S::P) wt[u * S::R + digit_of<LR>(t, k)] = x;
  }
  __syncthreads();
  if (t < S::R) {
    unsigned run = 0u;
#pragma unroll
    for (int v = 0; v < S::U; ++v) {
      const unsigned s = wt[v * S::R + t];
      wt[v * S::R + t] = run;
      run += s;
    }
    ctot[t] = run;
  }
  __syncthreads();
}

// the thread's 16 outputs: carry + earlier rows + earlier threads of its
// row + its own earlier words of the same digit
template <int LR>
__device__ __forceinline__ void emit(int* p, int limit, bool vec,
                                     const unsigned (&w)[16],
                                     const unsigned (&excl)[16],
                                     const unsigned* wt,
                                     const unsigned* carry, int inclusive) {
  using S = ScanShape<LR>;
  const int t = threadIdx.x, u = t / S::ROW;
  unsigned run[S::KC], o[16];
#pragma unroll
  for (int k = 0; k < S::KC; ++k) {
    const int d = digit_of<LR>(t, k);
    run[k] = carry[d] + wt[u * S::R + d] + excl[k];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int k = j % S::KC;
    if (inclusive) run[k] += w[j];
    o[j] = run[k];
    if (!inclusive) run[k] += w[j];
  }
  store16<LR>(p, limit, vec, o);
}

// out[t, d] = sum_{d' < d} colsum[d'] + sum_{t' < t} x[t', d] (+ x[t, d]
// if inclusive) over an (nt, 2^LR) int32 matrix; CTA c of the cluster owns
// rows [c * block_rows, (c + 1) * block_rows), block_rows << LR a multiple
// of 4.  vec: x and out are 16-byte aligned.
template <int LR>
__global__ void __launch_bounds__(SCAN_THREADS, 1)
cluster_scan_kernel(const int* __restrict__ x, int* __restrict__ out, int nt,
                    int block_rows, int inclusive, int vec) {
  using S = ScanShape<LR>;
  __shared__ unsigned wt[SCAN_THREADS];
  __shared__ unsigned sums[MAX_CLUSTER * S::R];   // every block's columns
  __shared__ unsigned colsum[S::R], tot[S::R], carry[S::R], ctot[S::R];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int t = threadIdx.x, lane = t & 31;
  const int rlo = min(nt, c * block_rows);
  const int words = (min(nt, rlo + block_rows) - rlo) << LR;
  const int* xb = x + ((size_t)rlo << LR);
  int* ob = out + ((size_t)rlo << LR);
  const int nch = (words + CHUNK - 1) / CHUNK;
  unsigned w[16], excl[16];
  // every CTA of the cluster has started before any writes to another's
  // shared memory (step 2): arrive now, wait just before the writes
  cluster_arrive_relaxed();
  load16<LR>(xb, words, vec, w);

  // 1. the block's column sums: a block of one chunk is scanned at once
  // and keeps its words in registers; a longer one is summed first
  if (nch <= 1) {
    chunk_scan<LR>(w, excl, wt, ctot);
    if (t < S::R) colsum[t] = ctot[t];
  } else {
    if (t < S::R) colsum[t] = 0u;
    unsigned acc[S::KC];
#pragma unroll
    for (int k = 0; k < S::KC; ++k) acc[k] = 0u;
    for (int ch = 0; ch < nch; ++ch) {
      if (ch > 0) load16<LR>(xb + ch * CHUNK, words - ch * CHUNK, vec, w);
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j % S::KC] += w[j];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < S::KC; ++k) {
      unsigned v = acc[k];                 // fold the lanes of one digit
#pragma unroll
      for (int o = S::P; o < 32; o <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane < S::P) atomicAdd(&colsum[digit_of<LR>(t, k)], v);
    }
    __syncthreads();
  }

  // 2. each block's column sums to every CTA's shared memory (remote
  // stores, no round trip), one cluster barrier, then local reads only:
  // no CTA touches another's shared memory after it, so any may exit
  cluster_wait();
  if (t < S::R)
    for (int k = 0; k < C; ++k)
      cluster.map_shared_rank(sums, k)[c * S::R + t] = colsum[t];
  cluster_arrive();
  cluster_wait();
  if (t < S::R) {
    unsigned all = 0u, pre = 0u;
    for (int k = 0; k < C; ++k) {
      const unsigned v = sums[k * S::R + t];
      all += v;
      if (k < c) pre += v;
    }
    tot[t] = all;
    carry[t] = pre;
  }
  __syncthreads();
  if (t < 32) {                            // digit bases: one warp's scan
    constexpr int per = (S::R + 31) / 32;
    const int lo = lane * per;
    unsigned s = 0u;
#pragma unroll
    for (int k = 0; k < per; ++k)
      if (lo + k < S::R) s += tot[lo + k];
    unsigned incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    unsigned run = incl - s;
#pragma unroll
    for (int k = 0; k < per; ++k)
      if (lo + k < S::R) {
        carry[lo + k] += run;
        run += tot[lo + k];
      }
  }
  __syncthreads();

  // 3. the outputs
  if (nch <= 1) {
    emit<LR>(ob, words, vec, w, excl, wt, carry, inclusive);
  } else {
    for (int ch = 0; ch < nch; ++ch) {
      const int left = words - ch * CHUNK;
      load16<LR>(xb + ch * CHUNK, left, vec, w);
      chunk_scan<LR>(w, excl, wt, ctot);
      emit<LR>(ob + ch * CHUNK, left, vec, w, excl, wt, carry, inclusive);
      __syncthreads();
      if (t < S::R) carry[t] += ctot[t];
    }
  }
}

using ScanKernel = void (*)(const int*, int*, int, int, int, int);
const ScanKernel SCAN_KERNELS[9] = {
    cluster_scan_kernel<0>, cluster_scan_kernel<1>, cluster_scan_kernel<2>,
    cluster_scan_kernel<3>, cluster_scan_kernel<4>, cluster_scan_kernel<5>,
    cluster_scan_kernel<6>, cluster_scan_kernel<7>, cluster_scan_kernel<8>};

cudaLaunchConfig_t cluster_config(int C, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(SCAN_THREADS);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the largest cluster the card places for radix 2^lr (it needs C SMs of
// one GPC free at once), asked once
int max_cluster(int lr) {
  static int cached[9] = {};
  if (cached[lr] > 0) return cached[lr];
  const ScanKernel k = SCAN_KERNELS[lr];
  if (cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess)
    return 1;
  for (int C = MAX_CLUSTER; C > 1; --C) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(C, &attr);
    int active = 0;
    if (cudaOccupancyMaxActiveClusters(&active, k, &cfg) == cudaSuccess &&
        active > 0)
      return cached[lr] = C;
    cudaGetLastError();                    // clear a refusal
  }
  return cached[lr] = 1;
}

// the cluster rule: a CTA per MIN_CTA_WORDS words, up to the largest
// cluster the card places
int rule_cluster(int words, int lr) {
  return std::max(1, std::min(max_cluster(lr),
                              (words + MIN_CTA_WORDS - 1) / MIN_CTA_WORDS));
}

}  // namespace

// r = 1: a 1-D scan of n = nt elements; r > 1: the digit-major offsets of
// an (nt, r) histogram, r a power of two up to 256.  cluster: the CTAs of
// the one cluster launched, 1 to 16, or 0 for the rule
extern "C" int tile_scan_add(const void* x, void* out, int n, int nt, int r,
                             int inclusive, int cluster, void* stream) {
  if (n < 1 || nt < 1 || r < 1 || r > 256 || (r & (r - 1)) != 0 ||
      (long long)nt * r != n || cluster < 0 || cluster > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  int lr = 0;
  while ((1 << lr) < r) ++lr;
  const ScanKernel k = SCAN_KERNELS[lr];
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  const int C = cluster > 0 ? cluster : rule_cluster(n, lr);
  // blocks of whole rows and of a multiple of 4 words (16-byte accesses)
  const int unit = r >= 4 ? 1 : 4 >> lr;
  const int units = (nt + unit - 1) / unit;
  const int block_rows = (units + C - 1) / C * unit;
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(C, &attr);
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&cfg, k, static_cast<const int*>(x),
                           static_cast<int*>(out), nt, block_rows, inclusive,
                           vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What the compiler and the occupancy calculator give K5's kernel for
// radix r: out[0..7] = registers a thread, local (spill) bytes a thread,
// static shared bytes, dynamic shared bytes a launch, CTAs an SM can hold,
// the largest cluster the card places, how many of those it holds at
// once, and the rule's cluster for a call of `words` words.
extern "C" int tile_scan_add_attrs(int words, int r, int* out) {
  if (r < 1 || r > 256 || (r & (r - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  int lr = 0;
  while ((1 << lr) < r) ++lr;
  const ScanKernel k = SCAN_KERNELS[lr];
  cudaError_t err = kernel_attrs(k, SCAN_THREADS, 0, out);
  const int C = max_cluster(lr);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(C, &attr);
  int active = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&active, k, &cfg);
  if (err != cudaSuccess) return (int)err;
  out[5] = C;
  out[6] = active;
  out[7] = rule_cluster(words, lr);
  return cudaSuccess;
}

extern "C" int tile_scan_logspace(const void* la, const void* ms,
                                  const void* C, const void* n,
                                  const void* la0, const void* m0,
                                  const void* C0, const void* n0,
                                  void* la_out, void* m_out, void* C_out,
                                  void* n_out, int L, int G, int FC, int FN,
                                  int inclusive, void* stream) {
  if (L < 1 || L > MAX_L || G < 1 || G > 65535 || FC < 4 || FN < 4 ||
      FC % 4 != 0 || FN % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int tilesC = (FC + TILE - 1) / TILE;
  const int tilesN = (FN + TILE - 1) / TILE;
  dim3 grid(tilesC + tilesN, G);
  const size_t smem = 2 * sizeof(float) * (size_t)L;  // <= 16 KB
  logspace_scan_kernel<<<grid, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(la), static_cast<const float*>(ms),
      static_cast<const float*>(C), static_cast<const float*>(n),
      static_cast<const float*>(la0), static_cast<const float*>(m0),
      static_cast<const float*>(C0), static_cast<const float*>(n0),
      static_cast<float*>(la_out), static_cast<float*>(m_out),
      static_cast<float*>(C_out), static_cast<float*>(n_out), L, G, FC, FN,
      tilesC, inclusive);
  return (int)cudaGetLastError();
}

extern "C" int tile_scan_affine(const void* a, const void* b, const void* a0,
                                const void* h0, void* gain_out, void* h_out,
                                int B, int L, int F, int inclusive,
                                void* stream) {
  if (B < 1 || B > 65535 || L < 1 || F < 4 || F % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int per_cta = THREADS * 4;
  dim3 grid((F + per_cta - 1) / per_cta, B);
  affine_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(a0), static_cast<const float*>(h0),
      static_cast<float*>(gain_out), static_cast<float*>(h_out), L, F,
      inclusive);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
