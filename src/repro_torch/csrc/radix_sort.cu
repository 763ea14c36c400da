// K6a, K6b, K7a and K7b: the stable radix sort's kernels for Hopper
// (sm_90a).  K7a and K7b rank on one device routine, a stable pass over a
// tile held in registers at a compile-time digit width (rank_place,
// radix_rank.cuh), and K6a on its own copy of it; K7b's first design (v1,
// kept to be timed against) ranks on rank_pass, a tile in shared memory.
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
// rank_place) gives each lane the lanes with its digit; the popcount of
// those below it is its rank among equal digits in this step, and the
// lowest such lane advances a per-(digit, warp) counter.  An exclusive
// scan of the (digit, warp) counts in digit-major order gives each
// segment's first rank, so the order of ranks is (digit, warp chunk, step,
// lane), which is (digit, index): stable.
//
// rank_pass (K7b v1, and K3 in moe_dispatch.cu) keeps the tile in two
// shared buffers and ping-pongs: one sweep counts, the scan, a second sweep
// ranks and scatters, about five CTA barriers a pass.
//
// rank_place.  Each thread holds its keys in registers, warp-striped, so
// (step, lane) is index order in the warp's chunk.  One ballot sweep a pass
// gives each key both its offset among the equal digits before it in the
// warp and the (digit, warp) counts; every thread scans a run of the
// counts in registers and the CTA scans the threads' totals (two
// barriers); every key goes to base[digit, warp] + offset in one shared
// buffer; one barrier.  Four barriers and one sweep a pass.  The digit
// width is a template argument: the ballots and the scan unroll with no
// branch on it, which did more for K6a than any grid change.
//
// K7a v2.  v1 ran rank_pass 8 times for 32 bits with 4-bit digits, 23x its
// byte bound at tile 1024.  A stable LSD sort by the same bits has one
// result whatever its digit width, so v2 ranks 8 bits a pass (4 passes for
// 32 bits; a pass wholly at bit 32 or above is the identity and is
// skipped) whatever digit_bits the caller gives, the keys back to
// registers from the buffer between passes.  Up to tile 1024 a CTA has 128
// threads (8 KB of shared memory at tile 1024: 4 KB of keys, 4 KB of
// counters; at most 64 registers a thread), so 8 CTAs fit an SM and 1024
// tiles run in one wave; larger tiles take 256.
//
// K7b v2.  v1 runs rank_pass once a digit_bits-wide digit (3 passes of 4
// bits for 12-bit keys), 12x its byte bound at 2^20 keys.  v2 is K7a v2
// with the composite key << log2(tile) | pos packed in registers after
// the load, and ceil(bits / 8) passes of one width w <= 8 fixed at compile
// time (bits: the key bits below bit 32 of the composite), the last pass
// masked to what is left: w = ceil(bits / passes) rounded up to an even
// width, so 12-bit keys take 2 passes of 6 bits and 17-bit keys 3 of 6.
// The pack or unpack, with the sentinel or idx_mask for slots at n or
// above, is applied to 16-byte loads of the sorted buffer on their way
// out.  The CTA shape follows the tile count (k7b_threads): with at least
// one tile an SM, K7a's; below that an SM runs one CTA, whose time is its
// chain of sweeps and barriers, and 256 threads (4 keys a thread at tile
// 1024) halve each warp's sweep.  Timed at tile 1024 (chip_smoke.py), 256
// threads beat 128, 512 and 1024 at 1 and 32 tiles, 1024 the slowest
// (wider CTAs pay for their barriers and their longer scan of the warps'
// totals), and 128 threads won at 1024 tiles.
//
// K6a v2.  v1 ran rank_pass on a 256-thread CTA with two word buffers
// (16.5 KB at tile 1024): the tile loaded and stored 4 bytes at a time, two
// match sweeps, six barriers.  v2 is one pass of rank_place's sweep and
// scan at the pass digit (bits <= 8): the keys packed in registers after
// the load; the digit sums of the scan are the histogram row; 16-byte
// stores.  128 threads up to tile 1024 (4.3 KB of shared memory), 256
// above.  Timed against one CTA a tile and dropped: a persistent grid
// of one wave whose CTAs stream their next tile in while they rank this
// one, into a second stage by a bulk copy (cp.async.bulk on an mbarrier)
// or into registers; both lost at 2^20 and 2^24 words.  A rank by
// counting (a column of counters a thread) lost to the ballots too.
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
constexpr int NUM_SMS = 132;             // H100 SXM

// dynamic shared memory of K7b v1: two word buffers of the tile, the
// (digit, warp) counts and the scan scratch
size_t tile_smem(int tile) {
  return sizeof(unsigned) * (2 * (size_t)tile + WARPS * MAX_RADIX + WARPS + 1);
}

// K7a's CTA: 128 threads up to tile 1024 (more CTAs an SM), 256 above
constexpr int K7A_SMALL_THREADS = 128;
constexpr int K7A_SMALL_TILE = 1024;

int k7a_threads(int tile) {
  return tile <= K7A_SMALL_TILE ? K7A_SMALL_THREADS : THREADS;
}

// K7b v2's CTA for nt tiles: K7a's with at least one tile an SM, else 256
// threads from tile 256 up
int k7b_threads(int tile, int nt) {
  if (nt >= NUM_SMS || tile < THREADS) return k7a_threads(tile);
  return THREADS;
}

// CTAs an SM K7a and K7b are built for: 8 at 128 threads (at most 64
// registers a thread), so 1024 tiles of up to 1024 keys run in one wave on
// 132 SMs; wider CTAs take the registers the compiler gives them.  Left to
// itself the compiler gave K7a 80 and K7b 69 registers at tile 1024; timed
// in turns, the cap made K7a faster and K7b no slower.
constexpr int rank_min_ctas(int threads) { return threads == 128 ? 8 : 1; }

// dynamic shared memory of a rank_place kernel: one word buffer of the
// tile and the (warp, digit) counters
size_t rank_smem(int tile, int threads, int radix) {
  return sizeof(unsigned) * ((size_t)tile + threads / 32 * radix);
}

// K7a v2: every tile sorted by bits [key_shift, key_shift + total_bits),
// its keys in registers, 8-bit digits (see the notes above).  NT threads, K
// keys a thread, warp-striped as rank_place takes them.
template <int K, int NT>
__global__ void __launch_bounds__(NT, rank_min_ctas(NT))
tile_sort_kernel(const unsigned* __restrict__ x, unsigned* __restrict__ out,
                 int tile, int key_shift, int total_bits) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* buf = smem;                                  // [tile]
  int* cnt = reinterpret_cast<int*>(smem + tile);        // [NW][256]
  __shared__ int wtot[NT / 32];
  const int first = (threadIdx.x >> 5) * 32 * K + (threadIdx.x & 31);
  const size_t off = (size_t)blockIdx.x * tile;
  unsigned key[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int i = first + 32 * s;
    key[s] = i < tile ? x[off + i] : 0u;
  }
  bool placed = false;                   // the tile lies in buf, in order
  for (int lo = 0; lo < total_bits && key_shift + lo < 32; lo += 8) {
    // a pass by bits at 32 or above is the identity: those bits are 0
    if (placed) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int i = first + 32 * s;
        if (i < tile) key[s] = buf[i];
      }
    }
    rank_place<K, NT, 8>(key, key_shift + lo,
                         (1u << min(8, total_bits - lo)) - 1u, tile, buf,
                         cnt, wtot);
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

// K7b v1: pack, sort by the key digits above log2(tile), emit packed words
// or (unpack) the int32 order; slots past n become the sentinel / idx_mask
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

// K7b's output word for the sorted composite c of the tile at `off`
struct PackedOut {
  unsigned off, pos_mask, n, idx_mask;
  int lb, idx_bits, unpack;
  __device__ __forceinline__ unsigned operator()(unsigned c) const {
    const unsigned gidx = off + (c & pos_mask);
    const bool real = gidx < n;
    return unpack ? (real ? gidx : idx_mask)
                  : (real ? shl(c >> lb, idx_bits) | gidx : SENTINEL);
  }
};

// K7b v2: the composite key << lb | pos sorted by the key bits below bit
// 32, passes of BITS bits (the last masked), keys in registers (see the
// notes above); NT threads, K keys a thread, warp-striped
template <int K, int NT, int BITS>
__global__ void __launch_bounds__(NT, rank_min_ctas(NT))
packed_tile_sort_v2_kernel(const unsigned* __restrict__ keys,
                           unsigned* __restrict__ out, int tile, int lb,
                           int n, int idx_bits, int sort_bits, int unpack) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* buf = smem;                                  // [tile]
  int* cnt = reinterpret_cast<int*>(smem + tile);        // [NW][2^BITS]
  __shared__ int wtot[NT / 32];
  const int first = (threadIdx.x >> 5) * 32 * K + (threadIdx.x & 31);
  const size_t off = (size_t)blockIdx.x * tile;
  unsigned key[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int i = first + 32 * s;
    key[s] = i < tile ? keys[off + i] << lb | (unsigned)i : 0u;
  }
  // the composite's bits at 32 or above are 0: no pass ranks them
  const int bits = min(sort_bits, 32 - lb);
  for (int lo = 0; lo < bits; lo += BITS) {
    if (lo > 0) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int i = first + 32 * s;
        if (i < tile) key[s] = buf[i];
      }
    }
    rank_place<K, NT, BITS>(key, lb + lo, (1u << min(BITS, bits - lo)) - 1u,
                            tile, buf, cnt, wtot);
  }
  if (bits <= 0) {                       // no key bits: the tile's order
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int i = first + 32 * s;
      if (i < tile) buf[i] = key[s];
    }
    __syncthreads();
  }
  const PackedOut emit{(unsigned)off, (unsigned)tile - 1u, (unsigned)n,
                       idx_bits >= 32 ? FULL : (1u << idx_bits) - 1u, lb,
                       idx_bits, unpack};
  if (tile >= 4) {
    uint4* o4 = reinterpret_cast<uint4*>(out + off);
    const uint4* b4 = reinterpret_cast<const uint4*>(buf);
    for (int i = threadIdx.x; i < tile / 4; i += NT) {
      const uint4 c = b4[i];
      o4[i] = make_uint4(emit(c.x), emit(c.y), emit(c.z), emit(c.w));
    }
  } else {
    for (int i = threadIdx.x; i < tile; i += NT) out[off + i] = emit(buf[i]);
  }
}

// K6a v2: one digit pass, tile-local half, one CTA a tile, the keys in
// registers (see the notes above).  NT threads, K keys a thread,
// warp-striped as rank_place takes them: warp w owns words [w * 32K,
// (w + 1) * 32K) of the tile, lane l holds word w * 32K + 32 s + l as
// key[s].  The digit width BITS is a template argument.  The sweep and the
// scan are rank_place's (radix_rank.cuh) written out, with the histogram
// row taken from the digit-major scan: K6a on rank_place itself, timed in
// turns against this copy, ran faster at 2^20 keys and slower at 2^24,
// with either scan form, and slower still under a register cap.
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

// A rank_place kernel's attributes (attrs != nullptr: out[0..4] as
// kernel_attrs, out[5] threads a CTA), or cudaSuccess when it may launch
// with `smem` dynamic shared bytes; -1 asks the caller to launch
template <typename Kern>
int attrs_or_allow(Kern kernel, int threads, size_t smem, int* attrs) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (attrs == nullptr) return -1;
  attrs[5] = threads;
  return (int)kernel_attrs(kernel, threads, smem, attrs);
}

// K7a's instance for a tile: NT threads, K = tile / NT keys a thread (at
// least 1); attrs != nullptr asks for its attributes instead of a launch
template <int K, int NT>
int tile_sort_launch(const void* x, void* out, int nt, int tile,
                     int key_shift, int total_bits, cudaStream_t st,
                     int* attrs) {
  auto kernel = tile_sort_kernel<K, NT>;
  const size_t smem = rank_smem(tile, NT, 256);
  const int done = attrs_or_allow(kernel, NT, smem, attrs);
  if (done >= 0) return done;
  kernel<<<nt, NT, smem, st>>>(static_cast<const unsigned*>(x),
                               static_cast<unsigned*>(out), tile, key_shift,
                               total_bits);
  return (int)cudaGetLastError();
}

int tile_sort_dispatch(const void* x, void* out, int nt, int tile,
                       int key_shift, int total_bits, cudaStream_t st,
                       int* attrs) {
#define K7A_CASE(K, NT)                                                    \
  return tile_sort_launch<K, NT>(x, out, nt, tile, key_shift, total_bits, \
                                 st, attrs)
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

// K7b v2's digits for `sort_bits` key bits at bit lb of the composite:
// the width (ceil(bits / 8) passes of one width, rounded up to an even
// one) and the pass count, bits = the key bits below bit 32
void k7b_digits(int sort_bits, int lb, int* width, int* passes) {
  const int bits = std::min(sort_bits, 32 - lb);
  if (bits <= 0) {
    *width = 2;
    *passes = 0;
    return;
  }
  const int p = (bits + 7) / 8;
  *width = ((bits + p - 1) / p + 1) & ~1;
  *passes = (bits + *width - 1) / *width;
}

struct K7bArgs {
  const void* keys;
  void* out;
  int nt, tile, n, idx_bits, sort_bits, unpack;
  cudaStream_t st;
};

template <int K, int NT, int BITS>
int k7b_launch(const K7bArgs& a, int* attrs) {
  auto kernel = packed_tile_sort_v2_kernel<K, NT, BITS>;
  const size_t smem = rank_smem(a.tile, NT, 1 << BITS);
  const int done = attrs_or_allow(kernel, NT, smem, attrs);
  if (done >= 0) return done;
  kernel<<<a.nt, NT, smem, a.st>>>(
      static_cast<const unsigned*>(a.keys), static_cast<unsigned*>(a.out),
      a.tile, log2_int(a.tile), a.n, a.idx_bits, a.sort_bits, a.unpack);
  return (int)cudaGetLastError();
}

template <int K, int NT>
int k7b_widths(const K7bArgs& a, int width, int* attrs) {
  switch (width) {
    case 2: return k7b_launch<K, NT, 2>(a, attrs);
    case 4: return k7b_launch<K, NT, 4>(a, attrs);
    case 6: return k7b_launch<K, NT, 6>(a, attrs);
    default: return k7b_launch<K, NT, 8>(a, attrs);
  }
}

// K7b v2's instance: `threads` a CTA (0: k7b_threads' rule), K = tile /
// threads keys a thread (at least 1).  The shapes built: the rule's at
// every tile, and 512 and 1024 threads at tile 1024 (timed beside it)
int k7b_dispatch(const K7bArgs& a, int threads, int* attrs) {
  const int nt_ = threads > 0 ? threads : k7b_threads(a.tile, a.nt);
  int width, passes;
  k7b_digits(a.sort_bits, log2_int(a.tile), &width, &passes);
  if (attrs != nullptr) {
    attrs[6] = width;
    attrs[7] = passes;
  }
  const int k = std::max(1, a.tile / nt_);
#define K7B_CASE(K, NT) \
  if (nt_ == NT && k == K) return k7b_widths<K, NT>(a, width, attrs)
  K7B_CASE(1, 128);
  K7B_CASE(2, 128);
  K7B_CASE(4, 128);
  K7B_CASE(8, 128);
  K7B_CASE(8, 256);
  K7B_CASE(16, 256);
  K7B_CASE(32, 256);
  K7B_CASE(1, 256);
  K7B_CASE(2, 256);
  K7B_CASE(4, 256);
  K7B_CASE(2, 512);
  K7B_CASE(1, 1024);
#undef K7B_CASE
  return (int)cudaErrorInvalidValue;
}

// K6a v2 launched, or (attrs != nullptr) its attributes: out[0..4] as
// kernel_attrs, out[5] threads a CTA
template <int K, int NT, int BITS>
int mt_local_v2_launch(const void* x, void* local, void* hist, int nt,
                       int tile, int shift, int pack, int idx_bits,
                       cudaStream_t st, int* attrs) {
  auto kernel = mt_local_v2_kernel<K, NT, BITS>;
  const size_t smem = rank_smem(tile, NT, 1 << BITS);
  const int done = attrs_or_allow(kernel, NT, smem, attrs);
  if (done >= 0) return done;
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

int mt_local_entry(const void* x, void* local, void* hist, int nt, int tile,
                   int shift, int bits, int pack, int idx_bits,
                   cudaStream_t st, int* attrs) {
  if (nt < 1 || !pow2_tile(tile) || shift < 0 || bits < 1 || bits > 8 ||
      idx_bits < 0)
    return (int)cudaErrorInvalidValue;
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
int mt_scatter_entry(const void* local, const void* hist, const void* base,
                     void* out, int nt, int tile, int radix,
                     unsigned unpack_mask, int unpack, cudaStream_t st,
                     int* attrs) {
  if (nt < 1 || tile < 1 || tile > MAX_TILE || radix < 2 ||
      radix > MAX_RADIX || (radix & (radix - 1)) != 0)
    return (int)cudaErrorInvalidValue;
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
  return tile_sort_dispatch(nullptr, nullptr, 0, tile, 0, 0, nullptr, out);
}

// v2 = 1: K7b v2 with `threads` a CTA (0: the rule); 0: v1 (digit_bits
// wide passes on rank_pass, 256 threads; `threads` unused).  v2 ranks
// ceil(bits / 8) passes whatever digit_bits says (see the notes above).
extern "C" int radix_tile_sort_packed(const void* keys, void* out, int nt,
                                      int tile, int n, int idx_bits,
                                      int sort_bits, int digit_bits,
                                      int unpack, int v2, int threads,
                                      void* stream) {
  if (nt < 1 || !pow2_tile(tile) || n < 0 || idx_bits < 0 || sort_bits < 0 ||
      digit_bits < 1 || digit_bits > 8 || threads < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (v2)
    return k7b_dispatch({keys, out, nt, tile, n, idx_bits, sort_bits, unpack,
                         st}, threads, nullptr);
  const size_t smem = tile_smem(tile);
  const cudaError_t err = allow_smem(packed_tile_sort_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  packed_tile_sort_kernel<<<nt, THREADS, smem, st>>>(
      static_cast<const unsigned*>(keys), static_cast<unsigned*>(out), tile,
      log2_int(tile), n, idx_bits, sort_bits, digit_bits, unpack);
  return (int)cudaGetLastError();
}

// What the compiler and the occupancy calculator give K7b v2's instance
// for nt tiles of `tile` and `sort_bits` key bits (`threads` a CTA, 0: the
// rule): out[0..5] as radix_tile_sort_attrs, out[6] the digit width,
// out[7] the passes.
extern "C" int radix_tile_sort_packed_attrs(int tile, int nt, int sort_bits,
                                            int threads, int* out) {
  if (nt < 1 || !pow2_tile(tile) || sort_bits < 0 || threads < 0)
    return (int)cudaErrorInvalidValue;
  return k7b_dispatch({nullptr, nullptr, nt, tile, 0, 0, sort_bits, 0,
                       nullptr}, threads, out);
}

extern "C" int radix_mt_local(const void* x, void* local, void* hist, int nt,
                              int tile, int shift, int bits, int pack,
                              int idx_bits, void* stream) {
  return mt_local_entry(x, local, hist, nt, tile, shift, bits, pack, idx_bits,
                        static_cast<cudaStream_t>(stream), nullptr);
}

// What the compiler and the occupancy calculator give K6a's instance for
// `tile` and `bits`: out[0..5] = registers a thread, local (spill) bytes a
// thread, static shared bytes, dynamic shared bytes a launch, CTAs an SM
// can hold, threads a CTA.
extern "C" int radix_mt_local_attrs(int tile, int bits, int* out) {
  return mt_local_entry(nullptr, nullptr, nullptr, 1, tile, 0, bits, 0, 0,
                        nullptr, out);
}

extern "C" int radix_mt_scatter(const void* local, const void* hist,
                                const void* base, void* out, int nt,
                                int tile, int radix, unsigned unpack_mask,
                                int unpack, void* stream) {
  return mt_scatter_entry(local, hist, base, out, nt, tile, radix,
                          unpack_mask, unpack,
                          static_cast<cudaStream_t>(stream), nullptr);
}

// The same for K6b at `tile`: out[0..5]
extern "C" int radix_mt_scatter_attrs(int tile, int radix, int* out) {
  return mt_scatter_entry(nullptr, nullptr, nullptr, nullptr, 1, tile, radix,
                          0, 0, nullptr, out);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
