// K6a, K6b, K7a and K7b: the stable radix sort's kernels for Hopper
// (sm_90a).  K7b (and K6a's v1) rank on one device routine, a stable
// in-tile rank by one digit (rank_pass, radix_rank.cuh); K7a and K6a v2
// rank their keys in registers.
//
// Replaces, in repro/kernels/radix_sort.py:
//   K7a radix_tile_sort        (body _radix_sort_kernel): in-tile stable LSD
//       sort of u32 words by bits [key_shift, key_shift + total_bits);
//   K7b radix_tile_sort_packed (body _fused_tile_sort_kernel): pack
//       key << log2(tile) | pos, sort by the key digits only, emit
//       key << idx_bits | gidx (or, with unpack, the int32 order);
//   K6a _mt_local              (body _mt_local_kernel): one multi-tile digit
//       pass, tile-local half: stable sort by the pass digit plus the
//       per-tile digit histogram (pass 0 packs key << idx_bits | gidx);
//   K6b _mt_scatter            (body _mt_scatter_kernel): the global half:
//       every (tile, digit) segment to its global base offset.
//
// What bounds them on this card: bytes.  Each kernel reads its tile once
// from device memory and writes it once (8 bytes a word, plus R counts a
// tile), a few hundred integer operations per word at most, far below the
// card's integer rate.  At 2^20 words the byte bound is 2.5 us.  The
// digit passes of K7 run inside one CTA on the tile held on chip, so in
// practice their cost is the latency of the passes' chain of warp sweeps
// and CTA barriers, not device bytes; the designs keep every pass there.
//
// Design.  The TPU kernels rank by a masked cumsum over a (G, m, R) one-hot
// and place by a one-hot matmul, because the TPU has no 1-D gathers or
// scatters.  The card has both in shared memory: one CTA per tile places
// each word by a scatter to its rank.
//
// Stability is the hazard.  A word's rank must be exactly (words of smaller
// digit in the tile) + (earlier words of the same digit).  A rank taken
// from the return value of a shared atomicAdd follows the order in which
// threads happen to run, so it is not stable.  Both routines give each warp
// a contiguous chunk of the tile and walk it 32 words at a time in index
// order.  A match (__match_any_sync in rank_pass, a ballot a digit bit in
// K7a and K6a v2) gives each lane the lanes with its digit; the popcount
// of those below it is its rank among equal digits in this step, and the
// lowest such lane (the leader) advances a per-(digit, warp) counter.  An
// exclusive scan of the (digit, warp) counts in digit-major order gives
// each segment's first rank, so the order of ranks is (digit, warp chunk,
// step, lane), which is (digit, index): stable.
//
// rank_pass (K7b, K6a v1, and K3 in moe_dispatch.cu) keeps the tile in two
// shared buffers and ping-pongs: one sweep counts, the scan, a second sweep
// ranks and scatters, about five CTA barriers a pass.
//
// K7a v2.  v1 ran rank_pass 8 times for 32 bits with 4-bit digits: two
// match sweeps, about five barriers and a round trip of the tile through
// shared memory a pass, some 40 barriers and 64 sweeps a warp for a
// 1024-word tile, 23x its byte bound.  A stable LSD sort by the same bits
// has one result whatever its digit width, so v2 ranks 8 bits a pass (4
// passes for 32 bits; a pass wholly at bit 32 or above is the identity and
// is skipped) whatever digit_bits the caller gives.  Each thread holds its
// keys in registers, warp-striped, so (step, lane) is index order in the
// warp's chunk.  One match sweep a pass gives each key both its offset
// among the equal digits before it in the warp and, through the leaders'
// counter updates, the (digit, warp) counts; the warp remembers each key's
// offset in a register.  Each thread then scans its digits' per-warp
// counts in registers and the CTA scans the threads' totals (two
// barriers); every key goes to base[digit, warp] + offset in one shared
// buffer; one barrier; the keys come back to registers for the next pass.
// Four barriers and one sweep a pass.  Up to tile 1024 a CTA has 128
// threads (8 KB of shared memory at tile 1024: 4 KB of keys, 4 KB of
// counters, against v1's 16 KB), so 9 CTAs fit an SM and 1024 tiles run
// in one wave; larger tiles take 256.
//
// K6a v2.  v1 ran rank_pass on a 256-thread CTA with two word buffers
// (16.5 KB at tile 1024): the tile loaded and stored 4 bytes at a time
// through a round trip in shared memory, two match sweeps, six barriers,
// a 256-thread scan of 8 x 16 counts and a second loop to sum `hist`.  v2
// is one pass of K7a v2 at the pass digit (bits <= 8: one ballot a bit):
// the keys in registers, warp-striped, packed there after the load; one
// sweep; the digit-major scan in registers plus one scan of the threads'
// totals, whose digit sums are the `hist` row; one scatter into a single
// shared buffer; 16-byte stores out.  Four barriers.  128 threads up to
// tile 1024 (4.3 KB of shared memory), 256 above.  The digit width is a
// template argument, so the ballots and the scan unroll with no branch on
// it; with the width at run time the sweep cost far more.  Timed against
// one CTA a tile and dropped: a persistent grid of one wave whose CTAs
// stream their next tile in while they rank this one, into a second stage
// by a bulk copy (cp.async.bulk on an mbarrier) or into registers; both
// lost at 2^20 and 2^24 words.  A rank by counting (a column of counters a
// thread) lost to the fixed-width ballots too.
//
// K6b: the TPU design does not carry over.  The reference revisits the
// whole output across its sequential grid steps, copying masked windows by
// read-modify-write into an output padded by one tile.  A Hopper grid runs
// in no order.  But each (tile, digit) segment has its own contiguous
// destination, disjoint from every other: one CTA per tile writes element
// j of its locally sorted tile straight to base[t, d] + j - lstart[t, d].
// No read-modify-write, no spare tile, and the order of CTAs does not
// matter; K6b fuses the last pass's & idx_mask unpack.  v1 scanned the
// tile's counts with a 256-thread block scan (three barriers) and searched
// the segment of every word (log2 R dependent shared loads), one word a
// thread at a time.  v2 loads all of a thread's words first (warp-striped:
// each warp instruction reads, and within a segment writes, 32
// consecutive words), one warp scans the counts by shuffles behind one
// barrier, and each thread searches once and then walks forward: the words
// are in digit order, so the segment only advances.  A run of consecutive
// words a thread, read 16 bytes at a time, was timed too and lost by far:
// each of its store instructions spreads over 8 lines.
#include "radix_rank.cuh"

#include <algorithm>
#include <climits>

namespace {

constexpr int MAX_TILE = 1 << 13;
constexpr int MAX_RADIX = 256;
constexpr unsigned SENTINEL = 0xffffffffu;
constexpr int RADIX8 = 256;              // K7a's digits are 8 bits wide

// dynamic shared memory of K6a and K7b: two word buffers of the tile,
// the (digit, warp) counts and the scan scratch
size_t tile_smem(int tile) {
  return sizeof(unsigned) * (2 * (size_t)tile + WARPS * MAX_RADIX + WARPS + 1);
}

// K7a's CTA: 128 threads up to tile 1024 (more CTAs an SM), 256 above
constexpr int K7A_SMALL_THREADS = 128;
constexpr int K7A_SMALL_TILE = 1024;

// K7a's dynamic shared memory: one word buffer of the tile and the
// (warp, digit) counters
size_t k7a_smem(int tile, int threads) {
  return sizeof(unsigned) * ((size_t)tile + threads / 32 * RADIX8);
}

struct Smem {
  unsigned* a;
  unsigned* b;
  int* cnt;
  int* ws;
};

__device__ __forceinline__ Smem carve(unsigned* smem, int tile) {
  Smem s;
  s.a = smem;
  s.b = smem + tile;
  s.cnt = reinterpret_cast<int*>(smem + 2 * tile);
  s.ws = s.cnt + WARPS * MAX_RADIX;
  return s;
}

// The lanes of the warp whose 8-bit digit equals this lane's, among the
// valid lanes (an invalid lane gets itself alone): one ballot a bit.
// __match_any_sync took longer the more distinct values a warp held (about
// 30 for random 8-bit digits) and lost to the ballots there; eight
// ballots cost the same whatever the digits.
__device__ __forceinline__ unsigned match8(unsigned digit, bool valid) {
  unsigned peers = __ballot_sync(FULL, valid);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (digit >> b) & 1u;
    const unsigned same = __ballot_sync(FULL, bit);
    peers &= bit ? same : ~same;
  }
  return valid ? peers : 1u << (threadIdx.x & 31);
}

// K7a v2: every tile sorted by bits [key_shift, key_shift + total_bits),
// its keys in registers, 8-bit digits (see the notes above).  NT threads, K
// keys a thread, warp-striped: warp w owns words [w * 32K, (w + 1) * 32K)
// of the tile and lane l holds word w * 32K + 32 s + l as key[s], so (s,
// lane) runs in index order within the warp's chunk.  Words past the tile
// (tiles below NT words) are masked lanes.
template <int K, int NT>
__global__ void __launch_bounds__(NT)
tile_sort_kernel(const unsigned* __restrict__ x, unsigned* __restrict__ out,
                 int tile, int key_shift, int total_bits) {
  constexpr int NW = NT / 32, DPT = RADIX8 / NT;   // warps, digits a thread
  extern __shared__ unsigned smem[];
  unsigned* buf = smem;                                  // [tile]
  int* cnt = reinterpret_cast<int*>(smem + tile);        // [NW][RADIX8]
  __shared__ int wtot[NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const size_t off = (size_t)blockIdx.x * tile;
  const int first = warp * 32 * K + lane;                // key[s]: first + 32 s
  int* mine = cnt + warp * RADIX8;
  unsigned key[K];
  int rank[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int i = first + 32 * s;
    key[s] = i < tile ? x[off + i] : 0u;
  }
  bool placed = false;                   // the tile lies in buf, in order
  for (int lo = 0; lo < total_bits && key_shift + lo < 32; lo += 8) {
    // a pass by bits at 32 or above is the identity: those bits are 0
    const int shift = key_shift + lo;
    const unsigned mask = (1u << min(8, total_bits - lo)) - 1u;
    if (placed) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int i = first + 32 * s;
        if (i < tile) key[s] = buf[i];
      }
    }
    for (int dd = lane; dd < RADIX8; dd += 32) mine[dd] = 0;
    __syncwarp();
    // 1. one match sweep: each key's offset among the equal digits before
    // it in the warp's chunk, and the (digit, warp) counts in `mine`
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const bool valid = first + 32 * s < tile;
      rank[s] = (int)match8(shr(key[s], shift) & mask, valid);
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const bool valid = first + 32 * s < tile;
      const unsigned dg = shr(key[s], shift) & mask;
      const unsigned peers = (unsigned)rank[s];
      const int leader = __ffs(peers) - 1;
      int before = 0;
      if (valid && lane == leader) {
        before = mine[dg];
        mine[dg] = before + __popc(peers);
      }
      before = __shfl_sync(FULL, before, leader);
      rank[s] = before + __popc(peers & below);
      __syncwarp();
    }
    __syncthreads();
    // 2. the first rank of every (digit, warp) segment, digit-major:
    // thread t scans the NW counts of its DPT digits in registers, the CTA
    // scans the threads' totals
    const int d0 = threadIdx.x * DPT;
    int v[DPT][NW], sum = 0;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        v[dd][w] = cnt[w * RADIX8 + d0 + dd];
        sum += v[dd][w];
      }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) wtot[warp] = incl;
    __syncthreads();
    int run = incl - sum;
    for (int w = 0; w < warp; ++w) run += wtot[w];
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        cnt[w * RADIX8 + d0 + dd] = run;
        run += v[dd][w];
      }
    __syncthreads();
    // 3. place every key at its rank
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (first + 32 * s < tile)
        buf[mine[shr(key[s], shift) & mask] + rank[s]] = key[s];
    }
    __syncthreads();
    placed = true;
  }
  if (!placed) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int i = first + 32 * s;
      if (i < tile) out[off + i] = key[s];
    }
  } else if (tile >= 4) {
    uint4* o4 = reinterpret_cast<uint4*>(out + off);
    const uint4* b4 = reinterpret_cast<const uint4*>(buf);
    for (int i = threadIdx.x; i < tile / 4; i += NT) o4[i] = b4[i];
  } else {
    for (int i = threadIdx.x; i < tile; i += NT) out[off + i] = buf[i];
  }
}

// K7b: pack, sort by the key digits above log2(tile), emit packed words or
// (unpack) the int32 order; slots past n become the sentinel / idx_mask
__global__ void __launch_bounds__(THREADS)
packed_tile_sort_kernel(const unsigned* __restrict__ keys,
                        unsigned* __restrict__ out, int tile, int lb, int n,
                        int idx_bits, int sort_bits, int digit_bits,
                        int unpack) {
  extern __shared__ unsigned smem[];
  Smem s = carve(smem, tile);
  const size_t off = (size_t)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += THREADS)
    s.a[i] = shl(keys[off + i], lb) | (unsigned)i;
  __syncthreads();
  for (int lo = 0; lo < sort_bits; lo += digit_bits) {
    rank_pass(s.a, s.b, tile, lb + lo, min(digit_bits, sort_bits - lo),
              s.cnt, s.ws, nullptr);
    unsigned* t = s.a;
    s.a = s.b;
    s.b = t;
  }
  const unsigned idx_mask = idx_bits >= 32 ? FULL : (1u << idx_bits) - 1u;
  const unsigned pos_mask = (unsigned)tile - 1u;
  for (int i = threadIdx.x; i < tile; i += THREADS) {
    const unsigned c = s.a[i];
    const unsigned gidx = (unsigned)off + (c & pos_mask);
    const bool real = gidx < (unsigned)n;
    out[off + i] = unpack ? (real ? gidx : idx_mask)
                          : (real ? shl(shr(c, lb), idx_bits) | gidx
                                  : SENTINEL);
  }
}

// K6a: one digit pass, tile-local half
__global__ void __launch_bounds__(THREADS)
mt_local_kernel(const unsigned* __restrict__ x, unsigned* __restrict__ local,
                int* __restrict__ hist, int tile, int shift, int bits,
                int pack, int idx_bits) {
  extern __shared__ unsigned smem[];
  Smem s = carve(smem, tile);
  const size_t off = (size_t)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += THREADS) {
    const unsigned w = x[off + i];
    s.a[i] = pack ? shl(w, idx_bits) | (unsigned)(off + i) : w;
  }
  __syncthreads();
  rank_pass(s.a, s.b, tile, shift, bits, s.cnt, s.ws,
            hist + (size_t)blockIdx.x * (1 << bits));
  for (int i = threadIdx.x; i < tile; i += THREADS) local[off + i] = s.b[i];
}

// K6b: one digit pass, global half: segment (t, d) of the locally sorted
// tile goes to out[base[t, d], base[t, d] + hist[t, d])
__global__ void __launch_bounds__(THREADS)
mt_scatter_kernel(const unsigned* __restrict__ local,
                  const int* __restrict__ hist, const int* __restrict__ base,
                  unsigned* __restrict__ out, int tile, int radix,
                  unsigned unpack_mask, int unpack) {
  __shared__ int lstart[MAX_RADIX];
  __shared__ int gbase[MAX_RADIX];
  __shared__ int ws[WARPS + 1];
  const size_t row = (size_t)blockIdx.x * radix;
  for (int d = threadIdx.x; d < radix; d += THREADS) {
    lstart[d] = hist[row + d];
    gbase[d] = base[row + d];
  }
  __syncthreads();
  block_exclusive_scan(lstart, radix, ws);
  const size_t off = (size_t)blockIdx.x * tile;
  for (int j = threadIdx.x; j < tile; j += THREADS) {
    // the segment holding j: the last digit whose local start is <= j
    // (an empty segment shares its start with the next one)
    int lo = 0, hi = radix - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (lstart[mid] <= j) lo = mid; else hi = mid - 1;
    }
    const unsigned w = local[off + j];
    out[(size_t)(gbase[lo] + (j - lstart[lo]))] = unpack ? (w & unpack_mask)
                                                         : w;
  }
}

// K6a v2's dynamic shared memory: the scatter buffer and the (warp,
// digit) counters
size_t k6a_smem(int tile, int threads, int radix) {
  return sizeof(unsigned) * ((size_t)tile + threads / 32 * radix);
}

// K6a v2: one digit pass, tile-local half, one CTA a tile, the keys in
// registers (see the notes above).  NT threads, K keys a thread,
// warp-striped as K7a's: warp w owns words [w * 32K, (w + 1) * 32K) of the
// tile, lane l holds word w * 32K + 32 s + l as key[s].  The digit width
// BITS is a template argument: the ballot loop and the scan then unroll
// with no branch on the width, which took a large share of the sweep.
template <int K, int NT, int BITS>
__global__ void __launch_bounds__(NT)
mt_local_v2_kernel(const unsigned* __restrict__ x,
                   unsigned* __restrict__ local, int* __restrict__ hist,
                   int tile, int shift, int pack, int idx_bits) {
  constexpr int NW = NT / 32, RADIX = 1 << BITS;
  constexpr int DPT = RADIX > NT ? RADIX / NT : 1;      // digits a thread
  extern __shared__ __align__(16) unsigned dyn[];
  unsigned* buf = dyn;                                   // [tile]
  int* cnt = reinterpret_cast<int*>(dyn + tile);         // [NW][RADIX]
  __shared__ int wtot[NW];
  // u32 shifts by 32 or more leave no bits (shl, shr), folded into masks
  const int sh = min(shift, 31), ish = min(idx_bits, 31);
  const unsigned dmask = shift >= 32 ? 0u : (unsigned)RADIX - 1u;
  const unsigned imask = idx_bits >= 32 ? 0u : FULL;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const size_t off = (size_t)blockIdx.x * tile;
  const int first = warp * 32 * K + lane;                // key[s]: first + 32 s
  int* mine = cnt + warp * RADIX;
  unsigned key[K], dg[K];
  int rank[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int i = first + 32 * s;
    key[s] = i < tile ? x[off + i] : 0u;
  }
  if (pack) {
    const unsigned g0 = (unsigned)(off + first);
#pragma unroll
    for (int s = 0; s < K; ++s)
      key[s] = ((key[s] << ish) & imask) | (g0 + 32 * s);
  }
#pragma unroll
  for (int s = 0; s < K; ++s) dg[s] = (key[s] >> sh) & dmask;
  for (int dd = lane; dd < RADIX; dd += 32) mine[dd] = 0;
  __syncwarp();
  // 1. one sweep of ballots: each key's offset among the equal digits
  // before it in the warp's chunk, and the (digit, warp) counts in `mine`.
  // Every lane reads its digit's count (one broadcast a digit), then the
  // lowest lane of each digit advances it.  (K7a's form, where that lane
  // alone reads the count and shuffles it to its peers, gave wrong counts
  // in one build of this kernel and right ones in another.)
#pragma unroll
  for (int s = 0; s < K; ++s) {
    unsigned peers = __ballot_sync(FULL, first + 32 * s < tile);
#pragma unroll
    for (int b = 0; b < BITS; ++b) {
      const unsigned B = __ballot_sync(FULL, (dg[s] >> b) & 1u);
      peers &= (dg[s] >> b) & 1u ? B : ~B;
    }
    rank[s] = (int)peers;
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool valid = first + 32 * s < tile;
    const unsigned peers = (unsigned)rank[s];
    const int before = valid ? mine[dg[s]] : 0;
    __syncwarp();
    if (valid && (peers & below) == 0) mine[dg[s]] = before + __popc(peers);
    rank[s] = before + __popc(peers & below);
    __syncwarp();
  }
  __syncthreads();
  // 2. the histogram row, and the first rank of every (digit, warp)
  // segment, digit-major: thread t scans the NW counts of its DPT digits
  // in registers, the CTA scans the threads' totals
  const int d0 = threadIdx.x * DPT;
  int v[DPT][NW], sum = 0;
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) {
    const bool own = d0 + dd < RADIX;
    int h = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      v[dd][w] = own ? cnt[w * RADIX + d0 + dd] : 0;
      h += v[dd][w];
    }
    if (own) hist[(size_t)blockIdx.x * RADIX + d0 + dd] = h;
    sum += h;
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += wtot[w];
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) {
    if (d0 + dd < RADIX) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        cnt[w * RADIX + d0 + dd] = run;
        run += v[dd][w];
      }
    }
  }
  __syncthreads();
  // 3. every key to its rank, then the tile out in 16-byte stores
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (first + 32 * s < tile) buf[mine[dg[s]] + rank[s]] = key[s];
  }
  __syncthreads();
  if (tile >= 4) {
    uint4* o4 = reinterpret_cast<uint4*>(local + off);
    const uint4* b4 = reinterpret_cast<const uint4*>(buf);
    for (int i = threadIdx.x; i < tile / 4; i += NT) o4[i] = b4[i];
  } else {
    for (int i = threadIdx.x; i < tile; i += NT) local[off + i] = buf[i];
  }
}

// K6b v2: one CTA a tile of NT threads, W words a thread, warp-striped:
// lane l of warp w holds words w * 32W + 32 k + l (k < W), so each load
// and each store instruction of a warp covers 32 consecutive words.  A
// thread's words rise, so after one search for its first word's segment
// it walks forward.
template <int W, int NT>
__global__ void __launch_bounds__(NT)
mt_scatter_v2_kernel(const unsigned* __restrict__ local,
                     const int* __restrict__ hist,
                     const int* __restrict__ base, unsigned* __restrict__ out,
                     int tile, int radix, unsigned unpack_mask, int unpack) {
  __shared__ int lstart[MAX_RADIX + 1];        // lstart[radix]: past the end
  __shared__ int delta[MAX_RADIX];             // base - lstart
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t off = (size_t)blockIdx.x * tile;
  const size_t row = (size_t)blockIdx.x * radix;
  const int j0 = warp * 32 * W + lane;         // word k: j0 + 32 k
  unsigned w[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j = j0 + 32 * k;
    w[k] = j < tile ? local[off + j] : 0u;
  }
  // one warp scans the tile's counts by shuffles: lane l holds digits
  // [l * dpl, (l + 1) * dpl), up to 8 a lane at radix 256
  if (warp == 0) {
    const int dpl = max(1, radix / 32);
    const int dl0 = lane * dpl;
    int c[8], sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c[i] = i < dpl && dl0 + i < radix ? hist[row + dl0 + i] : 0;
      sum += c[i];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - sum;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < dpl && dl0 + i < radix) {
        lstart[dl0 + i] = run;
        delta[dl0 + i] = base[row + dl0 + i] - run;
        run += c[i];
      }
    }
    if (lane == 0) lstart[radix] = INT_MAX;
  }
  __syncthreads();
  // the segment of the first word: the last digit whose local start is
  // <= j0 (an empty segment shares its start with the next one)
  int d = 0, hi = radix - 1;
  while (d < hi) {
    const int mid = (d + hi + 1) >> 1;
    if (lstart[mid] <= j0) d = mid; else hi = mid - 1;
  }
  int next = lstart[d + 1], dlt = delta[d];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j = j0 + 32 * k;
    if (j < tile) {
      while (next <= j) {
        ++d;
        next = lstart[d + 1];
        dlt = delta[d];
      }
      out[(size_t)(dlt + j)] = unpack ? (w[k] & unpack_mask) : w[k];
    }
  }
}

bool pow2_tile(int tile) {
  return tile >= 1 && tile <= MAX_TILE && (tile & (tile - 1)) == 0;
}

// above 48 KB a kernel must opt in to its dynamic shared memory
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int log2_int(int v) {
  int l = 0;
  while ((1 << (l + 1)) <= v) ++l;
  return l;
}

template <int K, int NT>
int launch_tile_sort(const void* x, void* out, int nt, int tile,
                     int key_shift, int total_bits, cudaStream_t st) {
  const size_t smem = k7a_smem(tile, NT);
  const cudaError_t err = allow_smem(tile_sort_kernel<K, NT>, smem);
  if (err != cudaSuccess) return (int)err;
  tile_sort_kernel<K, NT><<<nt, NT, smem, st>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(out), tile,
      key_shift, total_bits);
  return (int)cudaGetLastError();
}

template <int K, int NT>
cudaError_t tile_sort_attrs(int tile, int* out) {
  const size_t smem = k7a_smem(tile, NT);
  const cudaError_t err = allow_smem(tile_sort_kernel<K, NT>, smem);
  return err != cudaSuccess
             ? err
             : kernel_attrs(tile_sort_kernel<K, NT>, NT, smem, out);
}

// K7a's instance for a tile: NT threads, K = tile / NT keys a thread (at
// least 1); attrs != nullptr asks for its attributes instead of a launch
int tile_sort_dispatch(const void* x, void* out, int nt, int tile,
                       int key_shift, int total_bits, cudaStream_t st,
                       int* attrs) {
#define K7A_CASE(K, NT)                                                    \
  return attrs != nullptr                                                  \
             ? (int)tile_sort_attrs<K, NT>(tile, attrs)                    \
             : launch_tile_sort<K, NT>(x, out, nt, tile, key_shift,        \
                                       total_bits, st)
  if (tile <= K7A_SMALL_TILE) {
    constexpr int NT = K7A_SMALL_THREADS;
    switch (std::max(1, tile / NT)) {
      case 1: K7A_CASE(1, NT);
      case 2: K7A_CASE(2, NT);
      case 4: K7A_CASE(4, NT);
      default: K7A_CASE(K7A_SMALL_TILE / NT, NT);
    }
  }
  switch (tile / THREADS) {
    case 8: K7A_CASE(8, THREADS);
    case 16: K7A_CASE(16, THREADS);
    default: K7A_CASE(32, THREADS);
  }
#undef K7A_CASE
}

// K6a v2 launched, or (attrs != nullptr) its attributes: out[0..4] as
// kernel_attrs, out[5] threads a CTA
template <int K, int NT, int BITS>
int mt_local_v2_launch(const void* x, void* local, void* hist, int nt,
                       int tile, int shift, int pack, int idx_bits,
                       cudaStream_t st, int* attrs) {
  auto kernel = mt_local_v2_kernel<K, NT, BITS>;
  const size_t smem = k6a_smem(tile, NT, 1 << BITS);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (attrs != nullptr) {
    attrs[5] = NT;
    return (int)kernel_attrs(kernel, NT, smem, attrs);
  }
  kernel<<<nt, NT, smem, st>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(local),
      static_cast<int*>(hist), tile, shift, pack, idx_bits);
  return (int)cudaGetLastError();
}

// K6a's instance for a tile, as K7a's (128 threads up to tile 1024, 256
// above, K = tile / NT keys a thread, at least 1), at a digit width BITS
template <int BITS>
int mt_local_v2_tiles(const void* x, void* local, void* hist, int nt,
                      int tile, int shift, int pack, int idx_bits,
                      cudaStream_t st, int* attrs) {
#define K6A_CASE(K, NT)                                                     \
  return mt_local_v2_launch<K, NT, BITS>(x, local, hist, nt, tile, shift,   \
                                         pack, idx_bits, st, attrs)
  if (tile <= K7A_SMALL_TILE) {
    constexpr int NT = K7A_SMALL_THREADS;
    switch (std::max(1, tile / NT)) {
      case 1: K6A_CASE(1, NT);
      case 2: K6A_CASE(2, NT);
      case 4: K6A_CASE(4, NT);
      default: K6A_CASE(K7A_SMALL_TILE / NT, NT);
    }
  }
  switch (tile / THREADS) {
    case 8: K6A_CASE(8, THREADS);
    case 16: K6A_CASE(16, THREADS);
    default: K6A_CASE(32, THREADS);
  }
#undef K6A_CASE
}

int mt_local_v2_dispatch(const void* x, void* local, void* hist, int nt,
                         int tile, int shift, int bits, int pack,
                         int idx_bits, cudaStream_t st, int* attrs) {
#define K6A_BITS(B)                                                          \
  return mt_local_v2_tiles<B>(x, local, hist, nt, tile, shift, pack,         \
                              idx_bits, st, attrs)
  switch (bits) {
    case 1: K6A_BITS(1);
    case 2: K6A_BITS(2);
    case 3: K6A_BITS(3);
    case 4: K6A_BITS(4);
    case 5: K6A_BITS(5);
    case 6: K6A_BITS(6);
    case 7: K6A_BITS(7);
    default: K6A_BITS(8);
  }
#undef K6A_BITS
}

// K6b v2 launched, or its attributes (out[5] threads a CTA)
template <int W>
int mt_scatter_v2_launch(const void* local, const void* hist,
                         const void* base, void* out, int nt, int tile,
                         int radix, unsigned unpack_mask, int unpack,
                         cudaStream_t st, int* attrs) {
  auto kernel = mt_scatter_v2_kernel<W, THREADS>;
  if (attrs != nullptr) {
    attrs[5] = THREADS;
    return (int)kernel_attrs(kernel, THREADS, 0, attrs);
  }
  kernel<<<nt, THREADS, 0, st>>>(
      static_cast<const unsigned*>(local), static_cast<const int*>(hist),
      static_cast<const int*>(base), static_cast<unsigned*>(out), tile, radix,
      unpack_mask, unpack);
  return (int)cudaGetLastError();
}

// K6b's instance for a tile of at most MAX_TILE words: 256 threads, W =
// ceil(tile / 256) words a thread, at least 1
int mt_scatter_v2_dispatch(const void* local, const void* hist,
                           const void* base, void* out, int nt, int tile,
                           int radix, unsigned unpack_mask, int unpack,
                           cudaStream_t st, int* attrs) {
#define K6B_CASE(W)                                                          \
  return mt_scatter_v2_launch<W>(local, hist, base, out, nt, tile, radix,    \
                                 unpack_mask, unpack, st, attrs)
  switch ((tile + THREADS - 1) / THREADS) {
    case 1: K6B_CASE(1);
    case 2: K6B_CASE(2);
    case 3: case 4: K6B_CASE(4);
    case 5: case 6: case 7: case 8: K6B_CASE(8);
    default:
      if (tile <= 16 * THREADS) K6B_CASE(16);
      K6B_CASE(32);
  }
#undef K6B_CASE
}

// v2 = 0: v1, mt_local_kernel on rank_pass; 1: v2.  attrs != nullptr
// asks for the attributes (out[0..5]: kernel_attrs, threads a CTA).
int mt_local_entry(const void* x, void* local, void* hist, int nt, int tile,
                   int shift, int bits, int pack, int idx_bits, int v2,
                   cudaStream_t st, int* attrs) {
  if (nt < 1 || !pow2_tile(tile) || shift < 0 || bits < 1 || bits > 8 ||
      idx_bits < 0)
    return (int)cudaErrorInvalidValue;
  if (v2)
    return mt_local_v2_dispatch(x, local, hist, nt, tile, shift, bits, pack,
                                idx_bits, st, attrs);
  const size_t smem = tile_smem(tile);
  const cudaError_t err = allow_smem(mt_local_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (attrs != nullptr) {
    attrs[5] = THREADS;
    return (int)kernel_attrs(mt_local_kernel, THREADS, smem, attrs);
  }
  mt_local_kernel<<<nt, THREADS, smem, st>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(local),
      static_cast<int*>(hist), tile, shift, bits, pack, idx_bits);
  return (int)cudaGetLastError();
}

// v2 = 0: v1, mt_scatter_kernel; 1: v2 (tile <= MAX_TILE)
int mt_scatter_entry(const void* local, const void* hist, const void* base,
                     void* out, int nt, int tile, int radix,
                     unsigned unpack_mask, int unpack, int v2,
                     cudaStream_t st, int* attrs) {
  if (nt < 1 || tile < 1 || radix < 2 || radix > MAX_RADIX ||
      (radix & (radix - 1)) != 0 || (v2 && tile > MAX_TILE))
    return (int)cudaErrorInvalidValue;
  if (v2)
    return mt_scatter_v2_dispatch(local, hist, base, out, nt, tile, radix,
                                  unpack_mask, unpack, st, attrs);
  if (attrs != nullptr) {
    attrs[5] = THREADS;
    return (int)kernel_attrs(mt_scatter_kernel, THREADS, 0, attrs);
  }
  mt_scatter_kernel<<<nt, THREADS, 0, st>>>(
      static_cast<const unsigned*>(local), static_cast<const int*>(hist),
      static_cast<const int*>(base), static_cast<unsigned*>(out), tile, radix,
      unpack_mask, unpack);
  return (int)cudaGetLastError();
}

}  // namespace

// digit_bits is checked and otherwise unused: K7a ranks 8 bits a pass,
// and a stable LSD sort by the same bits has one result whatever its
// digit width
extern "C" int radix_tile_sort(const void* x, void* out, int nt, int tile,
                               int key_shift, int total_bits, int digit_bits,
                               void* stream) {
  if (nt < 1 || !pow2_tile(tile) || key_shift < 0 || total_bits < 0 ||
      digit_bits < 1 || digit_bits > 8)
    return (int)cudaErrorInvalidValue;
  return tile_sort_dispatch(x, out, nt, tile, key_shift, total_bits,
                            static_cast<cudaStream_t>(stream), nullptr);
}

// What the compiler and the occupancy calculator give K7a's instance for
// `tile`: out[0..5] = registers a thread, local (spill) bytes a thread,
// static shared bytes, dynamic shared bytes a launch, CTAs an SM can hold,
// threads a CTA.
extern "C" int radix_tile_sort_attrs(int tile, int* out) {
  if (!pow2_tile(tile)) return (int)cudaErrorInvalidValue;
  out[5] = tile <= K7A_SMALL_TILE ? K7A_SMALL_THREADS : THREADS;
  return tile_sort_dispatch(nullptr, nullptr, 0, tile, 0, 0, nullptr, out);
}

extern "C" int radix_tile_sort_packed(const void* keys, void* out, int nt,
                                      int tile, int n, int idx_bits,
                                      int sort_bits, int digit_bits,
                                      int unpack, void* stream) {
  if (nt < 1 || !pow2_tile(tile) || n < 0 || idx_bits < 0 || sort_bits < 0 ||
      digit_bits < 1 || digit_bits > 8)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem(tile);
  cudaError_t err = allow_smem(packed_tile_sort_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  packed_tile_sort_kernel<<<nt, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(keys), static_cast<unsigned*>(out), tile,
      log2_int(tile), n, idx_bits, sort_bits, digit_bits, unpack);
  return (int)cudaGetLastError();
}

extern "C" int radix_mt_local(const void* x, void* local, void* hist, int nt,
                              int tile, int shift, int bits, int pack,
                              int idx_bits, int v2, void* stream) {
  return mt_local_entry(x, local, hist, nt, tile, shift, bits, pack, idx_bits,
                        v2, static_cast<cudaStream_t>(stream), nullptr);
}

// What the compiler and the occupancy calculator give K6a (v2 = 1) or its
// v1 (v2 = 0) for `tile` and `bits`: out[0..5] = registers a thread, local
// (spill) bytes a thread, static shared bytes, dynamic shared bytes a
// launch, CTAs an SM can hold, threads a CTA.
extern "C" int radix_mt_local_attrs(int tile, int bits, int v2, int* out) {
  return mt_local_entry(nullptr, nullptr, nullptr, 1, tile, 0, bits, 0, 0, v2,
                        nullptr, out);
}

extern "C" int radix_mt_scatter(const void* local, const void* hist,
                                const void* base, void* out, int nt,
                                int tile, int radix, unsigned unpack_mask,
                                int unpack, int v2, void* stream) {
  return mt_scatter_entry(local, hist, base, out, nt, tile, radix,
                          unpack_mask, unpack, v2,
                          static_cast<cudaStream_t>(stream), nullptr);
}

// The same for K6b (v2 = 1) or its v1 (v2 = 0) at `tile`: out[0..5]
extern "C" int radix_mt_scatter_attrs(int tile, int radix, int v2, int* out) {
  return mt_scatter_entry(nullptr, nullptr, nullptr, nullptr, 1, tile, radix,
                          0, 0, v2, nullptr, out);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
