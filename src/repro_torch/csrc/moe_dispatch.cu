// K3: the MoE dispatch for Hopper (sm_90a): the stable sort of the (T*K,)
// expert assignments by expert id, with every activation row moved into
// that order, plus the per-expert counts.
//
// Replaces: repro/kernels/radix_sort.py::moe_dispatch_sort (body
// _moe_dispatch_kernel, launched by _moe_dispatch_impl).
//
// What bounds it on this card.  Bytes at prefill: each of the T*K
// activation rows is read once and written once (at 4 x 2048 tokens, D
// 5120, bf16, K 1: 84 MB each way, 0.050 ms at 3.35 TB/s).  Latency at a
// decode step or a prefill chunk (T*K <= tile, one tile): 8 rows are
// 0.16 MB, 0.00005 ms of bytes, so the time is the chain of barriers and
// memory round trips each CTA runs, and how many SMs share the copies.
//
// The TPU kernel carries each row through its radix scatter as an f32
// matrix [x | e | p | tok] and permutes rows by a one-hot matmul, because
// the TPU has no row gather; its sequential grid runs a histogram sweep
// over every tile before the scatter sweep.  Neither carries over: here
// rows are copied, never computed, in their own dtype (16-byte words where
// the row allows, else 4 or 2), so xd equals x[tok[order]] bit for bit,
// and sorted_e, sorted_tok and sorted_p are written directly.
//
// One tile (every decode step and prefill chunk): ONE launch of
// moe_onetile_kernel, which ranks by counting.  The stable rank of
// assignment j among n <= tile is
//     #{i : e_i < e_j} + #{i < j : e_i == e_j},
// which needs no histogram, no scan and no CTA barrier: one warp gets it
// for a row from n / 32 shared-memory reads a lane and a warp sum.  So
// every CTA ranks the rows it copies itself and no CTA waits for another.
// The grid spreads the bytes over the card: the n rows are one flat array
// of words, each CTA of 128 threads copies a contiguous run of 128 * per
// of them (thread t the words t, t + 128, ...), per sized so that the
// copies fill about two CTAs an SM (k3_grid in kernels/radix_sort.py; 40
// CTAs of one word a thread at T = 8, D = 5120 bf16).  A thread issues all
// its loads first, then stages the ids in shared memory and ranks; the
// stores wait only for that: one memory round trip a CTA.  The CTA that
// holds word 0 of a row writes its sorted_e, sorted_tok and sorted_p; one
// more CTA, the last, writes the counts (a shared-memory histogram).
//
// Several tiles: TWO launches on one stream, as before: moe_hist_kernel
// (each tile's digit counts) then moe_scatter_kernel, in which every CTA
// sums the small (nt x radix) histogram itself (the digit's start over all
// tiles plus the counts of the tiles before its own), ranks its tile with
// rank_pass of radix_rank.cuh (the radix sort's routine) and copies its
// share of the tile's rows, one warp a row.  A Hopper grid runs in no
// order, so the histogram of every tile must be complete before any tile
// scatters; the reference makes one pallas_call in both cases.
//
// Both rank the digit e & (2^bits - 1), bits = ceil(log2(E+1)) as the
// reference's (5 for E = 16, up to 9); ragged n needs no sentinel rows.
// No launch makes a non-stream API call once the SM count is cached (the
// first launch), so launches may be captured in a CUDA graph.
#include "radix_rank.cuh"

#include <algorithm>

namespace {

constexpr int MAX_TILE = 2048;
constexpr int MAX_BITS = 9;
constexpr int MAX_RADIX = 1 << MAX_BITS;

// the one-tile kernel: CTA size, words a thread at most, and the rows one
// CTA's run of words can touch
constexpr int ONE_THREADS = 128;
constexpr int ONE_WARPS = ONE_THREADS / 32;
constexpr int ONE_MAX_PER = 8;
constexpr int ONE_MAX_ROWS = ONE_THREADS * ONE_MAX_PER + 2;

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

// One tile (n <= MAX_TILE assignments), ranked by counting.  CTAs 0 ..
// gridDim.x - 2 copy: CTA b the words [b * 128 * per, (b + 1) * 128 * per)
// of the flat (n * nv)-word array of assignment rows, thread t the words
// t + 128 u, u < per; word c of assignment row j is word c of x's row
// j / K, stored at word c of xd's row rank(j).  The last CTA writes the
// counts.  W: the copy word (uint4, unsigned or unsigned short), nv words
// a row.
template <typename W>
__global__ void __launch_bounds__(ONE_THREADS)
moe_onetile_kernel(const W* __restrict__ x, const int* __restrict__ experts,
                   const char* __restrict__ probs, W* __restrict__ xd,
                   int* __restrict__ sorted_e, int* __restrict__ sorted_tok,
                   char* __restrict__ sorted_p, int* __restrict__ counts,
                   int n, int K, int E, unsigned mask, long long nv, int per,
                   int p_size) {
  __shared__ unsigned ids[MAX_TILE];
  __shared__ int dest[ONE_MAX_ROWS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (blockIdx.x == gridDim.x - 1) {
    // counts do not depend on the order of the adds: atomics are exact here
    int* h = reinterpret_cast<int*>(ids);
    for (int d = tid; d < E; d += ONE_THREADS) h[d] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += ONE_THREADS) {
      const unsigned d = (unsigned)__ldg(experts + i) & mask;
      if (d < (unsigned)E) atomicAdd(&h[d], 1);
    }
    __syncthreads();
    for (int d = tid; d < E; d += ONE_THREADS) counts[d] = h[d];
    return;
  }
  const long long span = (long long)ONE_THREADS * per;
  const long long v0 = (long long)blockIdx.x * span;
  const long long v_end = min((long long)n * nv, v0 + span);
  const int r_first = (int)(v0 / nv);
  // a step of 128 words is step_rows rows and step_c words
  const int step_rows = (int)(ONE_THREADS / nv);
  const long long step_c = ONE_THREADS - step_rows * nv;
  const long long v_first = v0 + tid;
  const int j_first = (int)(v_first / nv);
  const long long c_first = v_first - (long long)j_first * nv;

  // 1. every load of this thread before anything waits
  W w[ONE_MAX_PER];
  {
    int j = j_first;
    long long c = c_first, v = v_first;
#pragma unroll
    for (int u = 0; u < ONE_MAX_PER; ++u) {
      if (u < per && v < v_end) w[u] = __ldg(x + (long long)(j / K) * nv + c);
      v += ONE_THREADS;
      j += step_rows;
      c += step_c;
      if (c >= nv) {
        c -= nv;
        ++j;
      }
    }
  }
  // 2. the ids, then the stable rank of each row this CTA touches: one
  // warp a row, lanes over the ids, one warp sum
  for (int i = tid; i < n; i += ONE_THREADS)
    ids[i] = (unsigned)__ldg(experts + i) & mask;
  __syncthreads();
  const int nr = (int)((v_end - 1) / nv) - r_first + 1;
  for (int rr = warp; rr < nr; rr += ONE_WARPS) {
    const int jr = r_first + rr;
    const unsigned ej = ids[jr];
    int below = 0;
    for (int i = lane; i < n; i += 32) {
      const unsigned ei = ids[i];
      below += (ei < ej) | ((ei == ej) & (i < jr));
    }
    below = __reduce_add_sync(FULL, below);
    if (lane == 0) {
      dest[rr] = below;
      if ((long long)jr * nv >= v0) {   // word 0 of row jr is this CTA's
        sorted_e[below] = __ldg(experts + jr);
        sorted_tok[below] = jr / K;
        if (p_size == 4)
          reinterpret_cast<unsigned*>(sorted_p)[below] =
              reinterpret_cast<const unsigned*>(probs)[jr];
        else
          reinterpret_cast<unsigned short*>(sorted_p)[below] =
              reinterpret_cast<const unsigned short*>(probs)[jr];
      }
    }
  }
  __syncthreads();
  // 3. the stores
  int j = j_first;
  long long c = c_first, v = v_first;
#pragma unroll
  for (int u = 0; u < ONE_MAX_PER; ++u) {
    if (u < per && v < v_end) xd[(long long)dest[j - r_first] * nv + c] = w[u];
    v += ONE_THREADS;
    j += step_rows;
    c += step_c;
    if (c >= nv) {
      c -= nv;
      ++j;
    }
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

// The one-tile grid (k3_grid in kernels/radix_sort.py mirrors it): words
// a thread so that the copies fill about two CTAs an SM, at most
// ONE_MAX_PER; out[0] copying CTAs, out[1] words a thread.
void onetile_grid(int n, long long nv, long long* out) {
  const long long total = (long long)n * nv;
  const long long want = 2LL * sm_count() * ONE_THREADS;
  const long long per = std::min<long long>(
      ONE_MAX_PER, std::max<long long>(1, (total + want - 1) / want));
  out[0] = (total + ONE_THREADS * per - 1) / (ONE_THREADS * per);
  out[1] = per;
}

template <typename W>
cudaError_t launch_onetile(const void* x, const void* experts,
                           const void* probs, void* xd, void* sorted_e,
                           void* sorted_tok, void* sorted_p, void* counts,
                           int n, int K, int E, int bits, long long nv,
                           int p_size, cudaStream_t s) {
  long long g[2];
  onetile_grid(n, nv, g);
  if (g[0] + 1 > 0x7fffffffLL) return cudaErrorInvalidValue;
  moe_onetile_kernel<W><<<(unsigned)(g[0] + 1), ONE_THREADS, 0, s>>>(
      static_cast<const W*>(x), static_cast<const int*>(experts),
      static_cast<const char*>(probs), static_cast<W*>(xd),
      static_cast<int*>(sorted_e), static_cast<int*>(sorted_tok),
      static_cast<char*>(sorted_p), static_cast<int*>(counts), n, K, E,
      (1u << bits) - 1u, nv, (int)g[1], p_size);
  return cudaGetLastError();
}

}  // namespace

// x (T, D) rows of row_bytes bytes; experts (T, K) int32; probs (T, K) of
// p_size bytes each; hist: nt * 2^bits int32 scratch (unused when the input
// is one tile); outputs xd (T*K rows), sorted_e, sorted_tok (int32),
// sorted_p (p_size bytes each), counts (E int32).  vec: the row copy's word
// in bytes (16, 4 or 2), which the caller has checked divides row_bytes and
// the alignment of x.  counting = 0 sends a one-tile input through the
// scatter kernel (rank_pass) instead of moe_onetile_kernel: the card check
// times the two in turns.
extern "C" int moe_dispatch(const void* x, const void* experts,
                            const void* probs, void* hist, void* xd,
                            void* sorted_e, void* sorted_tok, void* sorted_p,
                            void* counts, int T, int K, int E, int tile,
                            int bits, long long row_bytes, int vec,
                            int p_size, int counting, void* stream) {
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
  if (nt == 1 && counting) {
    const long long nv = row_bytes / vec;
    switch (vec) {
      case 16:
        return (int)launch_onetile<uint4>(x, experts, probs, xd, sorted_e,
                                          sorted_tok, sorted_p, counts, n, K,
                                          E, bits, nv, p_size, s);
      case 4:
        return (int)launch_onetile<unsigned>(x, experts, probs, xd, sorted_e,
                                             sorted_tok, sorted_p, counts, n,
                                             K, E, bits, nv, p_size, s);
      default:
        return (int)launch_onetile<unsigned short>(
            x, experts, probs, xd, sorted_e, sorted_tok, sorted_p, counts, n,
            K, E, bits, nv, p_size, s);
    }
  }
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

// What the compiler and the occupancy calculator give each kernel, then
// the one-tile grid of n assignments of row_bytes bytes in vec-byte words:
// out[0..4] = registers a thread, local (spill) bytes a thread, static
// shared bytes, dynamic shared bytes a launch, CTAs an SM can hold;
// out[5] = copying CTAs, out[6] = words a thread.  which: 0 =
// moe_onetile_kernel<uint4>, 1 = moe_scatter_kernel at tile 512, E 16, 2 =
// moe_hist_kernel.
extern "C" int moe_dispatch_attrs(int which, int n, int row_bytes, int vec,
                                  int* out) {
  cudaError_t err;
  switch (which) {
    case 0:
      err = kernel_attrs(moe_onetile_kernel<uint4>, ONE_THREADS, 0, out);
      break;
    case 1:
      err = kernel_attrs(moe_scatter_kernel, THREADS, scatter_smem(512, 32),
                         out);
      break;
    case 2:
      err = kernel_attrs(moe_hist_kernel, THREADS, 0, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || vec < 1 || row_bytes < vec) return (int)cudaErrorInvalidValue;
  long long g[2];
  onetile_grid(n, row_bytes / vec, g);
  out[5] = (int)g[0];
  out[6] = (int)g[1];
  return (int)cudaSuccess;
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
