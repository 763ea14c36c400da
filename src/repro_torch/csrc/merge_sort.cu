// K8, K9a, K9b and K9c: the stable merge sort's kernels for Hopper (sm_90a).
//
// K8: one merge level: every adjacent pair of `run`-long sorted runs
// merged, one launch per level.
//
// Replaces: repro/kernels/merge_sort.py::_merge_level (body
// _merge_level_kernel), with the co-rank search of _merge_path_starts and
// the window gathers of _extract_windows that the reference runs in jnp
// around the call.
//
// What bounds it on this card: bytes.  A level reads every word once and
// writes it once (8 bytes a word: 8 MB, 2.5 us at 2^20 words); the
// co-rank searches add log2(run) dependent loads per CTA and thread, and
// the merge a compare per output word.
//
// Design.  One CTA per output block of `block` words of one pair (the
// sort's tile, at most MAX_BLOCK).  Threads 0 and 1 binary-search the
// merge path at the block's two diagonals in device memory: the smallest
// ia with A[ia] > B[d - 1 - ia], so ties go to A (a_mid <= b_val in
// merge_sort.py:235) and the merge is stable.  The CTA loads its la words
// of A and block - la words of B into shared memory (the reference's two
// windows, never materialised in device memory here), each thread
// searches its own sub-diagonal there and merges its share sequentially,
// and the block leaves through shared memory in coalesced stores.  The
// reference merges a sentinel-masked bitonic concat(A, reverse(B)) instead,
// a network the TPU needs because it has no 1-D gathers.  Packed words
// are unique apart from the pad sentinels, so any correct stable merge
// gives the reference's words bit for bit.  The last level of an argsort
// fuses the & idx_mask unpack into the store.
//
// K9a, K9b, K9c: the comparison pipeline of method="bitonic" and
// fused=False, kept as the baseline beside the radix kernels.
//
// Replaces, in repro/kernels/merge_sort.py: K9a tile_sort (body
// _tile_sort_kernel), K9b _pack (_pack_kernel), K9c _unpack
// (_unpack_kernel).
//
// What bounds them on this card: bytes.  K9b and K9c read 4 bytes and
// write 4 bytes a word (8 MB, 2.5 us at 2^20 words).  K9a also reads and
// writes each word once, but its network does log2(tile)(log2(tile)+1)/2
// compare stages over the tile (55 at 1024), each a pass over shared memory
// and a __syncthreads: shared-memory traffic and barriers, not device
// bytes, are what it costs.
//
// Design.  K9a: one CTA per tile, the tile in shared memory (at most 2^13
// words, 32 KB), the reference's bitonic network stage by stage: pair
// (i, i ^ j) with i's j bit clear, ascending where i & k is 0.  It stays a
// comparison network on purpose (the method is the comparison baseline
// next to radix).  Sorting u32 values moves no payload, so any correct sort
// gives the reference's words bit for bit.  K9b and K9c: grid-stride
// elementwise passes in 16-byte vectors where both pointers allow, scalar
// words otherwise.
#include "common.cuh"

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCK = 4096;  // 2 x 16 KB of shared memory
constexpr int SORT_THREADS = 512;
constexpr int MAX_SORT_TILE = 1 << 13;   // 32 KB of shared memory
constexpr int EW_THREADS = 256;
constexpr unsigned SENTINEL = 0xffffffffu;

// number of A words among the first d words of the stable merge of
// A[0, na) and B[0, nb)
__device__ __forceinline__ int corank(const unsigned* A, int na,
                                      const unsigned* B, int nb, int d) {
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (A[mid] <= B[d - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
merge_level_kernel(const unsigned* __restrict__ x, unsigned* __restrict__ out,
                   int run, int block, int nb, unsigned unpack_mask,
                   int unpack) {
  extern __shared__ unsigned smem[];   // window [block], merged [block]
  __shared__ int co[2];
  const int pair = blockIdx.x / nb, b = blockIdx.x % nb;
  const size_t pair_off = (size_t)pair * 2 * run;
  const unsigned* A = x + pair_off;
  const unsigned* B = A + run;
  const int d0 = b * block, d1 = min(d0 + block, 2 * run);
  if (threadIdx.x < 2)
    co[threadIdx.x] = corank(A, run, B, run, threadIdx.x ? d1 : d0);
  __syncthreads();
  const int a0 = co[0], la = co[1] - co[0];
  const int len = d1 - d0, b0 = d0 - a0, lb = len - la;
  unsigned* wa = smem;
  unsigned* wb = smem + la;
  unsigned* merged = smem + block;
  for (int i = threadIdx.x; i < la; i += THREADS) wa[i] = A[a0 + i];
  for (int i = threadIdx.x; i < lb; i += THREADS) wb[i] = B[b0 + i];
  __syncthreads();
  const int per = (len + THREADS - 1) / THREADS;
  const int dd = min(len, (int)threadIdx.x * per), de = min(len, dd + per);
  int ia = corank(wa, la, wb, lb, dd), ib = dd - ia;
  for (int k = dd; k < de; ++k) {
    const bool take_a = ia < la && (ib >= lb || wa[ia] <= wb[ib]);
    merged[k] = take_a ? wa[ia++] : wb[ib++];
  }
  __syncthreads();
  unsigned* o = out + pair_off + d0;
  for (int i = threadIdx.x; i < len; i += THREADS) {
    const unsigned w = merged[i];
    o[i] = unpack ? (w & unpack_mask) : w;
  }
}

// K9a: every tile of `tile` words sorted ascending by the bitonic network
__global__ void __launch_bounds__(SORT_THREADS)
bitonic_sort_kernel(const unsigned* __restrict__ x,
                    unsigned* __restrict__ out, int tile) {
  extern __shared__ unsigned w[];
  const size_t off = (size_t)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += SORT_THREADS) w[i] = x[off + i];
  __syncthreads();
  for (int k = 2; k <= tile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < tile / 2; p += SORT_THREADS) {
        // the p-th index with its j bit clear, and its partner i ^ j
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const unsigned a = w[i], b = w[i + j];
        const bool up = (i & k) == 0;
        if ((a > b) == up) {
          w[i] = b;
          w[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += SORT_THREADS) out[off + i] = w[i];
}

__device__ __forceinline__ unsigned pack1(unsigned key, unsigned i,
                                          unsigned n, int idx_bits) {
  return i < n ? ((idx_bits >= 32 ? 0u : key << idx_bits) | i) : SENTINEL;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// K9b: out[i] = key[i] << idx_bits | i for i < n, the sentinel past n
__global__ void __launch_bounds__(EW_THREADS)
pack_kernel(const unsigned* __restrict__ keys, unsigned* __restrict__ out,
            int m, int n, int idx_bits) {
  const int stride = gridDim.x * EW_THREADS;
  const int tid = blockIdx.x * EW_THREADS + threadIdx.x;
  int done = 0;
  if (aligned16(keys) && aligned16(out)) {
    const int nv = m / 4;
    for (int v = tid; v < nv; v += stride) {
      const uint4 k = __ldg(reinterpret_cast<const uint4*>(keys) + v);
      const unsigned i = 4u * v;
      uint4 o;
      o.x = pack1(k.x, i, n, idx_bits);
      o.y = pack1(k.y, i + 1, n, idx_bits);
      o.z = pack1(k.z, i + 2, n, idx_bits);
      o.w = pack1(k.w, i + 3, n, idx_bits);
      reinterpret_cast<uint4*>(out)[v] = o;
    }
    done = 4 * nv;
  }
  for (int i = done + tid; i < m; i += stride)
    out[i] = pack1(keys[i], i, n, idx_bits);
}

// K9c: out[i] = int32(x[i] & idx_mask)
__global__ void __launch_bounds__(EW_THREADS)
unpack_kernel(const unsigned* __restrict__ x, int* __restrict__ out, int m,
              unsigned idx_mask) {
  const int stride = gridDim.x * EW_THREADS;
  const int tid = blockIdx.x * EW_THREADS + threadIdx.x;
  int done = 0;
  if (aligned16(x) && aligned16(out)) {
    const int nv = m / 4;
    for (int v = tid; v < nv; v += stride) {
      const uint4 k = __ldg(reinterpret_cast<const uint4*>(x) + v);
      int4 o;
      o.x = (int)(k.x & idx_mask);
      o.y = (int)(k.y & idx_mask);
      o.z = (int)(k.z & idx_mask);
      o.w = (int)(k.w & idx_mask);
      reinterpret_cast<int4*>(out)[v] = o;
    }
    done = 4 * nv;
  }
  for (int i = done + tid; i < m; i += stride) out[i] = (int)(x[i] & idx_mask);
}

// enough CTAs of an elementwise pass to cover m words four at a time,
// capped at a few waves (the grid strides over the rest)
unsigned ew_grid(int m) {
  const int want = (m / 4 + EW_THREADS - 1) / EW_THREADS;
  return (unsigned)std::max(1, std::min(want, 132 * 16));
}

}  // namespace

extern "C" int merge_level(const void* x, void* out, int n, int run,
                           int block, unsigned unpack_mask, int unpack,
                           void* stream) {
  if (run < 1 || run > n / 2 || n % (2 * run) != 0 || block < 1 ||
      block > MAX_BLOCK)
    return (int)cudaErrorInvalidValue;
  const int nb = (2 * run + block - 1) / block;   // output blocks a pair
  const long long grid = (long long)(n / (2 * run)) * nb;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(unsigned) * (size_t)block;
  merge_level_kernel<<<(unsigned)grid, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(out), run,
      block, nb, unpack_mask, unpack);
  return (int)cudaGetLastError();
}

extern "C" int bitonic_tile_sort(const void* x, void* out, int nt, int tile,
                                 void* stream) {
  if (nt < 1 || tile < 1 || tile > MAX_SORT_TILE || (tile & (tile - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  bitonic_sort_kernel<<<nt, SORT_THREADS, sizeof(unsigned) * (size_t)tile,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(out), tile);
  return (int)cudaGetLastError();
}

extern "C" int pack_keys(const void* keys, void* out, int m, int n,
                         int idx_bits, void* stream) {
  if (m < 1 || n < 0 || idx_bits < 0) return (int)cudaErrorInvalidValue;
  pack_kernel<<<ew_grid(m), EW_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(keys), static_cast<unsigned*>(out), m, n,
      idx_bits);
  return (int)cudaGetLastError();
}

extern "C" int unpack_order(const void* x, void* out, int m,
                            unsigned idx_mask, void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  unpack_kernel<<<ew_grid(m), EW_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<int*>(out), m, idx_mask);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
