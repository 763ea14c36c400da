// K4: single-launch chunked monoid scans for Hopper (sm_90a) — the mLSTM
// log-space carry (tree layout) and Mamba's affine recurrence (batched
// layout).
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

}  // namespace

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
