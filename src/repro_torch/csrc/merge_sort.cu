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
// writes it once (8 bytes a word: 8 MB, 2.5 us at 2^20 words).  What the
// bytes leave room for is latency: a CTA's chain of dependent steps (the
// co-rank search in device memory, the window load, the merge, the store)
// and, on the MoE path's 8192-word levels, the launch itself.
//
// Design, v2 (merge_level_v2_kernel<W>, the route): one CTA of 256
// threads per output block of `block` words of one pair, W words a thread
// (block <= 256 W).  The wrapper picks the block from n and run
// (kernels/merge_sort.py k8_block): the largest of 256 x 1, 2, 4, 8, 16
// words that leaves two CTAs an SM, at most 2 run, so a 2^20-word level
// merges 8 words a thread in 512 CTAs and an 8192-word level 1 word a
// thread in 32.  Steps:
//  1. the co-ranks of the block's two diagonals d (the smallest ia with
//     A[ia] > B[d - 1 - ia], so ties go to A and the merge is stable) by
//     a 32-ary search, one warp a diagonal: in each round the 32 lanes
//     load one probe A[p] and B[d - 1 - p] each, one ballot counts the
//     probes at or before the answer, and the warp narrows its interval
//     to the gap between two probes, with no CTA barrier.
//     ceil(log_33(run + 1)) rounds: 2 at run 1024, 3 at 2^14, 4 at 2^19;
//     none where the block is the whole pair (block = 2 run).  (128
//     probes a diagonal, 256 threads, took one round fewer but 3x the L2
//     requests, and at 512 CTAs the requests, not the rounds, bound it.)
//  2. the two windows into shared memory as 16-byte cp.async copies over
//     each window's aligned interior (each window placed at the phase its
//     first word has in device memory), the up to 3 words at each edge by
//     scalar loads: nothing outside the window is read.
//  3. each thread finds its sub-diagonal t * per in the windows by binary
//     search in shared memory and merges its per words into registers.
//  4. the words leave through shared memory (index i at i + i / 32, so
//     neither the threads' writes of W consecutive words nor the 4-word
//     reads meet a bank conflict) as 16-byte coalesced stores; the last
//     level of an argsort fuses the & idx_mask unpack into them.
// The reference merges a sentinel-masked bitonic concat(A, reverse(B))
// instead, a network the TPU needs because it has no 1-D gathers.  Packed
// words are unique apart from the pad sentinels, so any correct stable
// merge gives the reference's words bit for bit.
//
// v1 (merge_level_kernel, kept as the route v2 is timed against): one CTA
// of 256 threads per block of the sort's tile (at most MAX_BLOCK); threads
// 0 and 1 binary-search the two co-ranks in device memory while the rest
// wait, the windows load 4 bytes a thread, each thread merges 4 words into
// shared memory at a stride of 4 (bank conflicts) and the block leaves 4
// bytes a thread.
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
#include "tensor_core.cuh"

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

// ------------------------------------------------------------- K8 v2

constexpr int M2_THREADS = 256;
constexpr int M2_PROBES = 32;                 // probes a round: a warp
constexpr int M2_MAX_W = 16;
constexpr int M2_MAX_BLOCK = M2_MAX_W * M2_THREADS;

// shared words of a v2 CTA: the two windows (each at most 3 words off its
// phase, and rounded to 4) or the padded output block, whichever is larger
constexpr size_t m2_smem_words(int block) {
  return (size_t)block + block / 32 + 16;
}
__device__ __forceinline__ int pad32(int i) { return i + (i >> 5); }

// word phase of a global address within its 16-byte chunk
__device__ __forceinline__ int phase4(const unsigned* p) {
  return (int)((reinterpret_cast<size_t>(p) >> 2) & 3);
}

// a window of len words at src into shared memory at dst, where dst has
// the phase of src: 16-byte cp.async copies for the aligned interior,
// scalar words at the edges (no word outside the window is read)
__device__ __forceinline__ void load_window(unsigned* dst,
                                           const unsigned* src, int len) {
  const int head = min(len, (4 - phase4(src)) & 3);
  const int chunks = (len - head) >> 2;
  const int tail0 = head + 4 * chunks;
  for (int c = threadIdx.x; c < chunks; c += M2_THREADS)
    cp_async16(smem_addr(dst + head + 4 * c), src + head + 4 * c, true);
  const int t = threadIdx.x;         // threads 0-2 the head, 3-5 the tail
  if (t < head) dst[t] = __ldg(src + t);
  if (t >= 3 && t < 3 + len - tail0)
    dst[tail0 + t - 3] = __ldg(src + tail0 + t - 3);
}

// the co-rank of diagonal d of the pair (A, B) of runs of `run` words,
// searched by one warp: the answer lies in [lo, hi]; each round the 32
// lanes probe p = lo + lane * step (p < hi), the ballot counts the probes
// with A[p] <= B[d - 1 - p] (ties to A: they lie before the answer), and
// [lo, hi] narrows to the gap after the last true probe
__device__ __forceinline__ int warp_corank(const unsigned* A,
                                           const unsigned* B, int run,
                                           int d) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - run), hi = min(d, run);
  while (lo < hi) {
    const int L = hi - lo, step = (L + M2_PROBES - 1) / M2_PROBES;
    const int p = lo + lane * step;
    const bool f = p < hi && __ldg(A + p) <= __ldg(B + d - 1 - p);
    const int c = __popc(__ballot_sync(0xffffffffu, f));
    const int np = (L + step - 1) / step;         // probes below hi
    const int base = lo;
    if (c > 0) lo = base + (c - 1) * step + 1;
    if (c < np) hi = base + c * step;
  }
  return lo;
}

template <int W>
__global__ void __launch_bounds__(M2_THREADS)
merge_level_v2_kernel(const unsigned* __restrict__ x,
                      unsigned* __restrict__ out, int run, int block, int nb,
                      unsigned unpack_mask, int unpack) {
  extern __shared__ __align__(16) unsigned sm[];
  __shared__ int co[2];               // the block's two co-ranks
  const int t = threadIdx.x, warp = t >> 5;
  const int pair = blockIdx.x / nb, b = blockIdx.x - pair * nb;
  const size_t pair_off = (size_t)pair * 2 * run;
  const unsigned* A = x + pair_off;
  const unsigned* B = A + run;
  const int d0 = b * block, d1 = min(d0 + block, 2 * run), len = d1 - d0;

  // 1. co-ranks: warp 0 searches d0, warp 1 d1
  if (warp < 2) {
    const int c = warp_corank(A, B, run, warp ? d1 : d0);
    if ((t & 31) == 0) co[warp] = c;
  }
  __syncthreads();
  const int a0 = co[0], la = co[1] - co[0];
  const int b0 = d0 - a0, lb = len - la;

  // 2. the windows, each at its own phase
  unsigned* wa = sm + phase4(A + a0);
  unsigned* wb = sm + ((phase4(A + a0) + la + 3) & ~3) + phase4(B + b0);
  load_window(wa, A + a0, la);
  load_window(wb, B + b0, lb);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 3. my sub-diagonal, merged into registers
  const int per = (len + M2_THREADS - 1) / M2_THREADS;   // <= W
  const int dd = min(len, t * per), de = min(len, dd + per);
  int ia = corank(wa, la, wb, lb, dd), ib = dd - ia;
  unsigned v[W];
#pragma unroll
  for (int e = 0; e < W; ++e) {
    if (dd + e < de) {
      const bool take_a = ia < la && (ib >= lb || wa[ia] <= wb[ib]);
      v[e] = take_a ? wa[ia++] : wb[ib++];
    }
  }

  // 4. through shared memory (padded) into 16-byte coalesced stores
  __syncthreads();                   // every window read is done
#pragma unroll
  for (int e = 0; e < W; ++e)
    if (dd + e < de) sm[pad32(dd + e)] = v[e];
  __syncthreads();
  const unsigned mask = unpack ? unpack_mask : 0xffffffffu;
  unsigned* o = out + pair_off + d0;
  if (aligned16(o) && (len & 3) == 0) {
    for (int c = t; c < (len >> 2); c += M2_THREADS) {
      const int i = pad32(4 * c);    // 4 words of one 32-word row
      reinterpret_cast<uint4*>(o)[c] =
          make_uint4(sm[i] & mask, sm[i + 1] & mask, sm[i + 2] & mask,
                     sm[i + 3] & mask);
    }
  } else {
    for (int i = t; i < len; i += M2_THREADS) o[i] = sm[pad32(i)] & mask;
  }
}

template <int W>
int merge_v2_launch(const void* x, void* out, int run, int block, int nb,
                    long long grid, unsigned unpack_mask, int unpack,
                    cudaStream_t st, int* attrs) {
  const size_t smem = sizeof(unsigned) * m2_smem_words(block);  // < 48 KB
  if (attrs != nullptr) {
    attrs[5] = M2_THREADS;
    return (int)kernel_attrs(merge_level_v2_kernel<W>, M2_THREADS, smem,
                             attrs);
  }
  merge_level_v2_kernel<W><<<(unsigned)grid, M2_THREADS, smem, st>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(out), run,
      block, nb, unpack_mask, unpack);
  return (int)cudaGetLastError();
}

// v2's instance for a block: W = the words a thread merges, rounded up to
// a power of two
int merge_v2_dispatch(const void* x, void* out, int run, int block, int nb,
                      long long grid, unsigned unpack_mask, int unpack,
                      cudaStream_t st, int* attrs) {
  const int per = (block + M2_THREADS - 1) / M2_THREADS;
#define REPRO_M2_CASE(W)                                                      \
  if (per <= W)                                                               \
    return merge_v2_launch<W>(x, out, run, block, nb, grid, unpack_mask,      \
                              unpack, st, attrs);
  REPRO_M2_CASE(1)
  REPRO_M2_CASE(2)
  REPRO_M2_CASE(4)
  REPRO_M2_CASE(8)
  REPRO_M2_CASE(16)
#undef REPRO_M2_CASE
  return (int)cudaErrorInvalidValue;
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

// v2 = 1: merge_level_v2_kernel (the route; block <= M2_MAX_BLOCK, from
// k8_block), v2 = 0: v1 merge_level_kernel (block <= MAX_BLOCK)
extern "C" int merge_level(const void* x, void* out, int n, int run,
                           int block, unsigned unpack_mask, int unpack,
                           int v2, void* stream) {
  if (run < 1 || run > n / 2 || n % (2 * run) != 0 || block < 1 ||
      block > (v2 ? M2_MAX_BLOCK : MAX_BLOCK))
    return (int)cudaErrorInvalidValue;
  const int nb = (2 * run + block - 1) / block;   // output blocks a pair
  const long long grid = (long long)(n / (2 * run)) * nb;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (v2)
    return merge_v2_dispatch(x, out, run, block, nb, grid, unpack_mask,
                             unpack, st, nullptr);
  const size_t smem = 2 * sizeof(unsigned) * (size_t)block;
  merge_level_kernel<<<(unsigned)grid, THREADS, smem, st>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(out), run,
      block, nb, unpack_mask, unpack);
  return (int)cudaGetLastError();
}

// What the compiler and the occupancy calculator give K8 v2's instance for
// `block`: out[0..5] as bitonic_tile_sort_attrs gives them.
extern "C" int merge_level_attrs(int block, int* out) {
  if (block < 1 || block > M2_MAX_BLOCK) return (int)cudaErrorInvalidValue;
  return merge_v2_dispatch(nullptr, nullptr, 0, block, 0, 0, 0, 0, nullptr,
                           out);
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
