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

#include <cstdint>

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

// K5: the int32 sum scan with a carry, one CTA.
//
// Replaces: repro/kernels/tile_scan.py::tile_scan (body _scan_kernel) and
// histogram_offsets, which scans the (nt, R) digit histogram digit-major
// for the multi-tile radix sort.  The TPU kernel carries the sum of earlier
// blocks in a (1, 1) VMEM cell across its sequential grid.  A Hopper grid
// runs in no order, so one CTA loops over the array with the carry in
// registers and shared memory: one launch, as in the reference.
//
// What bounds it: bytes (read once, written once: 2 MB at this slice's
// largest histogram, 16384 x 16), but one CTA moves them, so in practice
// the latency of its loop (a round of loads and four barriers a step) and
// the rate at which one SM starts loads and stores.  So every access is
// coalesced:
//
// scan_add_kernel (1-D): chunks of SCAN_CHUNK elements staged in shared
// memory with neighbouring threads on neighbouring elements; each thread
// scans SCAN_ITEMS consecutive ones, warps combine by shuffles.
//
// histogram_scan_kernel (r a power of two, 2..256, 16-byte aligned input):
// the offsets in (nt, r) layout, no transposes, reading rows as they lie.
// A first sweep sums each digit's column (a thread always meets the same
// four digits); a digit's base is the exclusive scan of the columns before
// it.  Then slabs of rows are staged in shared memory (the next slab's
// loads in flight while one is scanned); thread (d, g) takes
// HIST_ROWS_PER_THREAD consecutive rows of digit d, a block-wide scan of
// the threads' sums in digit-major order gives each thread its prefix
// within its digit, and a per-digit carry crosses slabs.  Index arithmetic
// shifts by log2(r): an integer division per word cost more than the
// loads.  Sums wrap as int32 does.
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_CHUNK = SCAN_THREADS * SCAN_ITEMS;
// odd: lanes g and g + 1 read rows 11 (r + 1) words apart, an odd stride,
// so a warp's 32 reads fall in 32 banks
constexpr int HIST_ROWS_PER_THREAD = 11;
constexpr int HIST_SLAB = SCAN_THREADS * HIST_ROWS_PER_THREAD;  // words
// the padded slab (row stride r + 1, r >= 2): dynamic shared memory
constexpr size_t HIST_SMEM = sizeof(unsigned) * (HIST_SLAB + HIST_SLAB / 2);

// exclusive scan of one value per thread over the CTA, in thread order;
// wsum: shared scratch of SCAN_THREADS / 32.  Returns the thread's prefix
// and leaves the CTA total in *total.
__device__ __forceinline__ unsigned cta_exclusive_scan(unsigned v,
                                                       unsigned* wsum,
                                                       unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned s = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += y;
  }
  if (lane == 31) wsum[warp] = s;
  __syncthreads();
  if (warp == 0) {
    unsigned t = wsum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    wsum[lane] = t;
  }
  __syncthreads();
  const unsigned excl = s - v + (warp > 0 ? wsum[warp - 1] : 0u);
  *total = wsum[SCAN_THREADS / 32 - 1];
  __syncthreads();
  return excl;
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_add_kernel(const int* __restrict__ x, int* __restrict__ out, int n,
                int inclusive) {
  __shared__ unsigned buf[SCAN_CHUNK];
  __shared__ unsigned wsum[SCAN_THREADS / 32];
  unsigned carry = 0;
  for (int base = 0; base < n; base += SCAN_CHUNK) {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      const int q = j * SCAN_THREADS + threadIdx.x;
      const int k = base + q;
      buf[q] = k < n ? (unsigned)x[k] : 0u;
    }
    __syncthreads();
    unsigned v[SCAN_ITEMS], sum = 0;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      v[j] = buf[threadIdx.x * SCAN_ITEMS + j];
      sum += v[j];
    }
    unsigned total;
    unsigned run = carry + cta_exclusive_scan(sum, wsum, &total);
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      if (inclusive) run += v[j];
      buf[threadIdx.x * SCAN_ITEMS + j] = run;
      if (!inclusive) run += v[j];
    }
    carry += total;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      const int q = j * SCAN_THREADS + threadIdx.x;
      const int k = base + q;
      if (k < n) out[k] = (int)buf[q];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
histogram_scan_kernel(const int* __restrict__ x, int* __restrict__ out,
                      int nt, int lr, int inclusive) {
  // a slab of rows, row stride r + 1 against bank conflicts
  extern __shared__ unsigned slab[];
  __shared__ unsigned wsum[SCAN_THREADS / 32];
  __shared__ unsigned dbase[256], carry[256], start[256];
  const int tid = threadIdx.x;
  const int r = 1 << lr;                 // shifts: no integer division
  const unsigned rm = (unsigned)r - 1u;
  const size_t total = (size_t)nt * r;
  // 1. column sums, 16-byte loads, four in flight: word 4q + c of the
  // matrix has digit (4 tid + c) % r for every q = tid + k * SCAN_THREADS
  if (tid < r) carry[tid] = 0;
  __syncthreads();
  unsigned c[4] = {0u, 0u, 0u, 0u};
  const size_t n4 = total / 4;
  const int4* x4 = reinterpret_cast<const int4*>(x);
#pragma unroll 4
  for (size_t q = tid; q < n4; q += SCAN_THREADS) {
    const int4 v = __ldg(x4 + q);
    c[0] += (unsigned)v.x;
    c[1] += (unsigned)v.y;
    c[2] += (unsigned)v.z;
    c[3] += (unsigned)v.w;
  }
  for (size_t i = 4 * n4 + tid; i < total; i += SCAN_THREADS)
    atomicAdd(&carry[i & rm], (unsigned)x[i]);
#pragma unroll
  for (int j = 0; j < 4; ++j)            // a count: order-free
    atomicAdd(&carry[(4 * tid + j) & rm], c[j]);
  __syncthreads();
  // 2. each digit's base: the columns of smaller digits
  if (tid == 0) {
    unsigned run = 0;
    for (int d = 0; d < r; ++d) {
      dbase[d] = run;
      run += carry[d];
      carry[d] = 0;
    }
  }
  __syncthreads();
  // 3. slabs of rows; thread (d, g) owns rows [g * PER, g * PER + PER)
  const int rows = HIST_SLAB >> lr, groups = SCAN_THREADS >> lr;
  const int d = tid / groups, g = tid % groups;
  const int stride = r + 1;
  // a slab is exactly HIST_ROWS_PER_THREAD words a thread: word
  // tid + j * SCAN_THREADS of it, prefetched into registers
  unsigned next[HIST_ROWS_PER_THREAD];
  auto prefetch = [&](int row) {
    const int words = min(rows, nt - row) * r;
#pragma unroll
    for (int j = 0; j < HIST_ROWS_PER_THREAD; ++j) {
      const int i = tid + j * SCAN_THREADS;
      next[j] = i < words ? (unsigned)x[(size_t)row * r + i] : 0u;
    }
  };
  prefetch(0);
  for (int row0 = 0; row0 < nt; row0 += rows) {
    const int nrow = min(rows, nt - row0);
    const size_t off = (size_t)row0 * r;
#pragma unroll
    for (int j = 0; j < HIST_ROWS_PER_THREAD; ++j) {
      const int i = tid + j * SCAN_THREADS;
      if (i < nrow * r) slab[(i >> lr) * stride + (i & rm)] = next[j];
    }
    __syncthreads();
    if (row0 + rows < nt) prefetch(row0 + rows);
    unsigned v[HIST_ROWS_PER_THREAD], sum = 0;
#pragma unroll
    for (int j = 0; j < HIST_ROWS_PER_THREAD; ++j) {
      const int row = g * HIST_ROWS_PER_THREAD + j;
      v[j] = row < nrow ? slab[row * stride + d] : 0u;
      sum += v[j];
    }
    unsigned slab_total;
    const unsigned excl = cta_exclusive_scan(sum, wsum, &slab_total);
    if (g == 0) start[d] = excl;
    __syncthreads();
    const unsigned within = excl - start[d];   // earlier groups, digit d
    unsigned run = dbase[d] + carry[d] + within;
#pragma unroll
    for (int j = 0; j < HIST_ROWS_PER_THREAD; ++j) {
      const int row = g * HIST_ROWS_PER_THREAD + j;
      if (row < nrow) {
        if (inclusive) run += v[j];
        slab[row * stride + d] = run;
        if (!inclusive) run += v[j];
      }
    }
    __syncthreads();
    if (g == groups - 1) carry[d] += within + sum;
    for (int i = tid; i < nrow * r; i += SCAN_THREADS)
      out[off + i] = (int)slab[(i >> lr) * stride + (i & rm)];
    __syncthreads();
  }
}

}  // namespace

// r = 1: a 1-D scan of n = nt elements; r > 1: the digit-major offsets of
// an (nt, r) histogram, r a power of two up to 256, x 16-byte aligned
extern "C" int tile_scan_add(const void* x, void* out, int n, int nt, int r,
                             int inclusive, void* stream) {
  if (n < 1 || nt < 1 || r < 1 || r > 256 || (r & (r - 1)) != 0 ||
      (long long)nt * r != n ||
      (r > 1 && reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r == 1) {
    scan_add_kernel<<<1, SCAN_THREADS, 0, st>>>(
        static_cast<const int*>(x), static_cast<int*>(out), n, inclusive);
    return (int)cudaGetLastError();
  }
  const cudaError_t err = cudaFuncSetAttribute(
      histogram_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)HIST_SMEM);
  if (err != cudaSuccess) return (int)err;
  int lr = 0;
  while ((1 << lr) < r) ++lr;
  histogram_scan_kernel<<<1, SCAN_THREADS, HIST_SMEM, st>>>(
      static_cast<const int*>(x), static_cast<int*>(out), nt, lr, inclusive);
  return (int)cudaGetLastError();
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
