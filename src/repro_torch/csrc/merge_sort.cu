// K8: one merge level of the stable merge sort for Hopper (sm_90a): every
// adjacent pair of `run`-long sorted runs merged, one launch per level.
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
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCK = 4096;  // 2 x 16 KB of shared memory

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

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
