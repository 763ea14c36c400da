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
// What bounds them on this card: bytes.  Each reads 4 bytes and writes 4
// bytes a word (8 MB, 2.5 us at 2^20 words).  K9a's network also does
// log2(tile)(log2(tile)+1)/2 compare stages over each tile (55 at 1024),
// W compare-exchanges a thread each, which costs more than its bytes.
//
// Design, K9a v2: the reference's bitonic network (pair i, i ^ j with i's
// j bit clear, ascending where i & k is 0 or k is the whole tile) with the
// tile in registers.  It stays a comparison network on purpose (the method
// is the comparison baseline next to radix); sorting u32 values moves no
// payload, so any correct sort gives the reference's words bit for bit.
// A CTA of NT threads holds a block of W * NT words (one tile, or several
// small ones: k never exceeds the tile, so no stage crosses a tile), each
// thread W consecutive words, loaded and stored as 16-byte vectors
// (blocked layout: word i = t * W + e).  Where the stage's partner
// distance j lies decides where it runs:
//  - j < W: inside the thread, registers only;
//  - W <= j < 32 W: the partner is lane ^ (j / W) of the same warp, one
//    __shfl_xor_sync a word; each lane keeps the min or the max by its
//    direction bit;
//  - j >= 32 W: the block goes once through shared memory into the strided
//    layout (word i = t + NT * e), where every such j is a multiple of NT
//    (the (W, NT) pairs are chosen so that 32 W >= NT), so these stages run
//    inside the thread too, and back: two barriers for each merge step k
//    that has them (2 of 10 steps, 3 of 55 stages at tile 1024).
// (W, NT) by tile: (8, 128) up to 1024 words, (8, 256) at 2048, (16, 256)
// at 4096, (16, 512) at 8192.  128 threads at tile 1024 let 16 CTAs share
// an SM, so 2^20 words (1024 tiles) run in one wave.  Pad words past n fill
// whole tiles (n is a multiple of the tile) with the sentinel and are not
// stored.
//
// Design, K9b and K9c: grid-stride elementwise passes in 16-byte vectors
// where both pointers allow, scalar words otherwise.
#include "common.cuh"

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCK = 4096;  // 2 x 16 KB of shared memory
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

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// one compare-exchange: a gets the min and b the max if up, else the reverse
__device__ __forceinline__ void cmp_swap(unsigned& a, unsigned& b, bool up) {
  const unsigned lo = min(a, b), hi = max(a, b);
  a = up ? lo : hi;
  b = up ? hi : lo;
}

// K9a v2: every tile of `tile` words sorted ascending by the bitonic
// network, W words a thread in registers (see the notes above)
template <int W, int NT>
__global__ void __launch_bounds__(NT)
bitonic_sort_kernel(const unsigned* __restrict__ x,
                    unsigned* __restrict__ out, int n, int tile) {
  static_assert(W % 4 == 0 && 32 * W >= NT, "strided stages stay in-thread");
  constexpr int BLOCK = W * NT;
  extern __shared__ __align__(16) unsigned sbuf[];   // [BLOCK]
  const int t = threadIdx.x, lane = t & 31;
  const long long first = (long long)blockIdx.x * BLOCK + (long long)t * W;
  const bool vec = aligned16(x) && aligned16(out) && first + W <= n;
  unsigned v[W];
  if (vec) {
#pragma unroll
    for (int c = 0; c < W / 4; ++c) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(x + first) + c);
      v[4 * c] = q.x; v[4 * c + 1] = q.y; v[4 * c + 2] = q.z;
      v[4 * c + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e)
      v[e] = first + e < n ? x[first + e] : SENTINEL;
  }
  const int tw = t * W;                  // my first word within the block
  for (int k = 2; k <= tile; k <<= 1) {
    const bool whole = k >= tile;        // the last merge: all ascending
    if (k > 32 * W) {
      // stages j >= 32 W: blocked -> strided through shared memory, the
      // stages in registers (partner e ^ j / NT), strided -> blocked.  A
      // thread writes back only the words it read, and the blocked store
      // of the next step only its own words, so two barriers suffice
#pragma unroll
      for (int c = 0; c < W / 4; ++c)
        reinterpret_cast<uint4*>(sbuf + tw)[c] =
            make_uint4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
      __syncthreads();
      unsigned s[W];
#pragma unroll
      for (int e = 0; e < W; ++e) s[e] = sbuf[t + NT * e];
#pragma unroll
      for (int jj = W / 2; jj >= 1; jj >>= 1) {
        if (jj * NT < k && jj * NT >= 32 * W) {
#pragma unroll
          for (int e = 0; e < W; ++e)
            if ((e & jj) == 0)
              cmp_swap(s[e], s[e | jj], whole || ((t + NT * e) & k) == 0);
        }
      }
#pragma unroll
      for (int e = 0; e < W; ++e) sbuf[t + NT * e] = s[e];
      __syncthreads();
#pragma unroll
      for (int c = 0; c < W / 4; ++c) {
        const uint4 q = reinterpret_cast<const uint4*>(sbuf + tw)[c];
        v[4 * c] = q.x; v[4 * c + 1] = q.y; v[4 * c + 2] = q.z;
        v[4 * c + 3] = q.w;
      }
    }
    // stages W <= j < 32 W: the partner is lane ^ (j / W), same word slot
    const bool up = whole || (tw & k) == 0;   // k > j >= W: a bit of tw
    for (int j = min(k >> 1, 16 * W); j >= W; j >>= 1) {
      const int d = j / W;
      const bool keep_min = ((lane & d) == 0) == up;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const unsigned y = __shfl_xor_sync(0xffffffffu, v[e], d);
        v[e] = keep_min ? min(v[e], y) : max(v[e], y);
      }
    }
    // stages j < W: inside the thread
#pragma unroll
    for (int j = W / 2; j >= 1; j >>= 1) {
      if (j < k) {
#pragma unroll
        for (int e = 0; e < W; ++e)
          if ((e & j) == 0)
            cmp_swap(v[e], v[e | j], whole || ((tw + e) & k) == 0);
      }
    }
  }
  if (vec) {
#pragma unroll
    for (int c = 0; c < W / 4; ++c)
      reinterpret_cast<uint4*>(out + first)[c] =
          make_uint4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e)
      if (first + e < n) out[first + e] = v[e];
  }
}

__device__ __forceinline__ unsigned pack1(unsigned key, unsigned i,
                                          unsigned n, int idx_bits) {
  return i < n ? ((idx_bits >= 32 ? 0u : key << idx_bits) | i) : SENTINEL;
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

template <int W, int NT>
int bitonic_launch(const void* x, void* out, int n, int tile,
                   cudaStream_t st, int* attrs) {
  constexpr int BLOCK = W * NT;
  const size_t smem = sizeof(unsigned) * BLOCK;   // <= 32 KB: no opt-in
  if (attrs != nullptr) {
    attrs[5] = NT;
    return (int)kernel_attrs(bitonic_sort_kernel<W, NT>, NT, smem, attrs);
  }
  const long long grid = ((long long)n + BLOCK - 1) / BLOCK;
  bitonic_sort_kernel<W, NT><<<(unsigned)grid, NT, smem, st>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(out), n, tile);
  return (int)cudaGetLastError();
}

// K9a's (W, NT) for a tile (see the notes at the top)
int bitonic_dispatch(const void* x, void* out, int n, int tile,
                     cudaStream_t st, int* attrs) {
  if (tile <= 1024) return bitonic_launch<8, 128>(x, out, n, tile, st, attrs);
  if (tile == 2048) return bitonic_launch<8, 256>(x, out, n, tile, st, attrs);
  if (tile == 4096) return bitonic_launch<16, 256>(x, out, n, tile, st, attrs);
  return bitonic_launch<16, 512>(x, out, n, tile, st, attrs);
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

extern "C" int bitonic_tile_sort(const void* x, void* out, int n, int tile,
                                 void* stream) {
  if (n < 1 || tile < 1 || tile > MAX_SORT_TILE || (tile & (tile - 1)) != 0 ||
      n % tile != 0)
    return (int)cudaErrorInvalidValue;
  return bitonic_dispatch(x, out, n, tile, static_cast<cudaStream_t>(stream),
                          nullptr);
}

// What the compiler and the occupancy calculator give K9a's instance for
// `tile`: out[0..5] = registers a thread, local (spill) bytes a thread,
// static shared bytes, dynamic shared bytes a launch, CTAs an SM can hold,
// threads a CTA.
extern "C" int bitonic_tile_sort_attrs(int tile, int* out) {
  if (tile < 1 || tile > MAX_SORT_TILE || (tile & (tile - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  return bitonic_dispatch(nullptr, nullptr, 0, tile, nullptr, out);
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
