// K3: the MoE dispatch for Hopper (sm_90a): the stable sort of the (T*K,)
// expert assignments by expert id, with every activation row moved into
// that order, plus the per-expert counts.
//
// Replaces: repro/kernels/radix_sort.py::moe_dispatch_sort (body
// _moe_dispatch_kernel, launched by _moe_dispatch_impl).
//
// What bounds it on this card: bytes.  Each of the T*K activation rows is
// read once and written once (at 4 x 2048 tokens, D 5120, bf16, K 1: 84 MB
// each way, 0.050 ms at 3.35 TB/s); the ids, probabilities and tokens add
// 16 bytes a row.  A decode step (8 rows) is all launch latency.
//
// Design.  The TPU kernel carries each row through its radix scatter as an
// f32 matrix [x | e | p | tok] and permutes rows by a one-hot matmul,
// because the TPU has no row gather; its sequential grid runs a histogram
// sweep over every tile before the scatter sweep.  Neither carries over.
// Here the sort moves only a 32-bit composite (digit << log2(tile) | local
// index) and the rows are copied, never computed, in their own dtype: one
// warp per row in 16-byte vectors where the row allows, so xd equals
// x[tok[order]] bit for bit, and sorted_e, sorted_tok and sorted_p are
// written directly (no float round trip).
//
// Ordering.  A Hopper grid runs in no order, so the histogram of every
// tile must be complete before any tile scatters:
//   * one tile (T*K <= tile, e.g. a decode step): ONE launch, the scatter
//     kernel alone, its own tile histogram giving the global offsets;
//   * several tiles: TWO launches on one stream, moe_hist_kernel (each
//     tile's digit counts) then moe_scatter_kernel, in which every CTA sums
//     the small (nt x radix) histogram itself: the digit's start over all
//     tiles plus the counts of the tiles before its own.
// The reference makes one pallas_call in both cases.
//
// Stable rank: rank_pass of radix_rank.cuh (the radix sort's routine) over
// the tile's composites.  The digit is ceil(log2(E+1)) bits, as the
// reference's (5 for E = 16, up to 9); ragged n is handled by bounds
// checks, so no sentinel pad rows exist.  Row copies of a tile are split
// over gridDim.y CTAs (each re-ranks its tile: a few microseconds) so that
// about two CTAs per SM move rows even when there are few tiles; CTA y = 0
// of each tile writes the ids, tokens and probabilities, and CTA (0, 0) the
// per-expert counts that bound the grouped expert matmuls.
#include "radix_rank.cuh"

#include <algorithm>

namespace {

constexpr int MAX_TILE = 2048;
constexpr int MAX_BITS = 9;
constexpr int MAX_RADIX = 1 << MAX_BITS;

// dynamic shared memory of the scatter kernel: two composite buffers of the
// tile, the (digit, warp) counts, the scan scratch, and the local and
// global digit starts
size_t scatter_smem(int tile, int radix) {
  return sizeof(int) * (2 * (size_t)tile + WARPS * (size_t)radix + WARPS + 1 +
                        2 * (size_t)radix);
}

__global__ void __launch_bounds__(THREADS)
moe_hist_kernel(const int* __restrict__ experts, int* __restrict__ hist,
                int n, int tile, int radix) {
  __shared__ int h[MAX_RADIX];
  for (int d = threadIdx.x; d < radix; d += THREADS) h[d] = 0;
  __syncthreads();
  const long long off = (long long)blockIdx.x * tile;
  const int m = (int)min((long long)tile, n - off);
  const unsigned mask = (unsigned)radix - 1u;
  // counts do not depend on the order of the adds: atomics are exact here
  for (int i = threadIdx.x; i < m; i += THREADS)
    atomicAdd(&h[(unsigned)experts[off + i] & mask], 1);
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += THREADS)
    hist[(size_t)blockIdx.x * radix + d] = h[d];
}

// one row of row_bytes bytes by the 32 lanes of a warp, in vec-byte words
__device__ __forceinline__ void copy_row(char* __restrict__ dst,
                                         const char* __restrict__ src,
                                         long long row_bytes, int vec,
                                         int lane) {
  if (vec == 16) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* o = reinterpret_cast<uint4*>(dst);
    const int nv = (int)(row_bytes / 16);
    for (int k = lane; k < nv; k += 4 * 32) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (k + 32 * u < nv) v[u] = __ldg(s + k + 32 * u);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (k + 32 * u < nv) o[k + 32 * u] = v[u];
    }
  } else if (vec == 4) {
    const unsigned* s = reinterpret_cast<const unsigned*>(src);
    unsigned* o = reinterpret_cast<unsigned*>(dst);
    for (int k = lane; k < (int)(row_bytes / 4); k += 32) o[k] = s[k];
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    unsigned short* o = reinterpret_cast<unsigned short*>(dst);
    for (int k = lane; k < (int)(row_bytes / 2); k += 32) o[k] = s[k];
  }
}

__global__ void __launch_bounds__(THREADS)
moe_scatter_kernel(const char* __restrict__ x, const int* __restrict__ experts,
                   const char* __restrict__ probs,
                   const int* __restrict__ hist, char* __restrict__ xd,
                   int* __restrict__ sorted_e, int* __restrict__ sorted_tok,
                   char* __restrict__ sorted_p, int* __restrict__ counts,
                   int n, int K, int tile, int lb, int bits, int nt, int E,
                   long long row_bytes, int vec, int p_size) {
  extern __shared__ int sm[];
  const int radix = 1 << bits;
  unsigned* a = reinterpret_cast<unsigned*>(sm);
  unsigned* b = a + tile;
  int* cnt = reinterpret_cast<int*>(b + tile);
  int* ws = cnt + WARPS * radix;
  int* lstart = ws + WARPS + 1;
  int* gbase = lstart + radix;
  const int t = blockIdx.x;
  const long long off = (long long)t * tile;
  const int m = (int)min((long long)tile, n - off);
  const unsigned mask = (unsigned)radix - 1u;
  for (int i = threadIdx.x; i < m; i += THREADS)
    a[i] = (((unsigned)experts[off + i] & mask) << lb) | (unsigned)i;
  __syncthreads();
  // b = the tile's composites in stable digit order; lstart = its counts
  rank_pass(a, b, m, lb, bits, cnt, ws, lstart);
  // gbase[d] = the count of every smaller digit over all tiles, plus the
  // count of digit d in the tiles before this one (cnt reused as scratch)
  for (int d = threadIdx.x; d < radix; d += THREADS) {
    int total = 0, before = 0;
    if (hist == nullptr) {
      total = lstart[d];
    } else {
      for (int u = 0; u < nt; ++u) {
        const int h = hist[(size_t)u * radix + d];
        total += h;
        if (u < t) before += h;
      }
    }
    if (t == 0 && blockIdx.y == 0 && d < E) counts[d] = total;
    gbase[d] = total;
    cnt[d] = before;
  }
  __syncthreads();
  block_exclusive_scan(gbase, radix, ws);
  block_exclusive_scan(lstart, radix, ws);
  for (int d = threadIdx.x; d < radix; d += THREADS) gbase[d] += cnt[d];
  __syncthreads();
  const unsigned pos_mask = (unsigned)tile - 1u;
  if (blockIdx.y == 0) {
    for (int r = threadIdx.x; r < m; r += THREADS) {
      const unsigned c = b[r];
      const int d = (int)(c >> lb);
      const long long j = off + (c & pos_mask);
      const long long dest = gbase[d] + (r - lstart[d]);
      sorted_e[dest] = experts[j];
      sorted_tok[dest] = (int)(j / K);
      if (p_size == 4)
        reinterpret_cast<unsigned*>(sorted_p)[dest] =
            reinterpret_cast<const unsigned*>(probs)[j];
      else
        reinterpret_cast<unsigned short*>(sorted_p)[dest] =
            reinterpret_cast<const unsigned short*>(probs)[j];
    }
  }
  // the rows: this CTA's share of the tile, one warp per row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (m + (int)gridDim.y - 1) / (int)gridDim.y;
  const int r0 = (int)blockIdx.y * per, r1 = min(m, r0 + per);
  for (int r = r0 + warp; r < r1; r += WARPS) {
    const unsigned c = b[r];
    const int d = (int)(c >> lb);
    const long long tok = (off + (c & pos_mask)) / K;
    const long long dest = gbase[d] + (r - lstart[d]);
    copy_row(xd + dest * row_bytes, x + tok * row_bytes, row_bytes, vec,
             lane);
  }
}

bool pow2(int v) { return v >= 1 && (v & (v - 1)) == 0; }

int log2_int(int v) {
  int l = 0;
  while ((1 << (l + 1)) <= v) ++l;
  return l;
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || count < 1)
      count = 132;
  }
  return count;
}

}  // namespace

// x (T, D) rows of row_bytes bytes; experts (T, K) int32; probs (T, K) of
// p_size bytes each; hist: nt * 2^bits int32 scratch (unused when the input
// is one tile); outputs xd (T*K rows), sorted_e, sorted_tok (int32),
// sorted_p (p_size bytes each), counts (E int32).  vec: the row copy's word
// in bytes (16, 4 or 2), which the caller has checked divides row_bytes and
// the alignment of x.
extern "C" int moe_dispatch(const void* x, const void* experts,
                            const void* probs, void* hist, void* xd,
                            void* sorted_e, void* sorted_tok, void* sorted_p,
                            void* counts, int T, int K, int E, int tile,
                            int bits, long long row_bytes, int vec,
                            int p_size, void* stream) {
  const long long n_ll = (long long)T * K;
  if (T < 1 || K < 1 || n_ll > 0x7fffffffLL || !pow2(tile) ||
      tile > MAX_TILE || bits < 1 || bits > MAX_BITS || E < 1 ||
      E > (1 << bits) || row_bytes < 1 || (vec != 16 && vec != 4 && vec != 2) ||
      row_bytes % vec != 0 || (p_size != 4 && p_size != 2))
    return (int)cudaErrorInvalidValue;
  const int n = (int)n_ll;
  const int nt = (n + tile - 1) / tile;
  const int radix = 1 << bits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nt > 1) {
    if (hist == nullptr) return (int)cudaErrorInvalidValue;
    moe_hist_kernel<<<nt, THREADS, 0, s>>>(static_cast<const int*>(experts),
                                          static_cast<int*>(hist), n, tile,
                                          radix);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // about two CTAs per SM copy rows, at least one warp's row each
  const int rows = std::min(n, tile);
  const int ysplit = std::max(
      1, std::min((2 * sm_count() + nt - 1) / nt, (rows + WARPS - 1) / WARPS));
  const dim3 grid(nt, ysplit);
  moe_scatter_kernel<<<grid, THREADS, scatter_smem(tile, radix), s>>>(
      static_cast<const char*>(x), static_cast<const int*>(experts),
      static_cast<const char*>(probs),
      nt > 1 ? static_cast<const int*>(hist) : nullptr,
      static_cast<char*>(xd), static_cast<int*>(sorted_e),
      static_cast<int*>(sorted_tok), static_cast<char*>(sorted_p),
      static_cast<int*>(counts), n, K, tile, log2_int(tile), bits, nt, E,
      row_bytes, vec, p_size);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
