// The stable in-tile rank by one digit, shared by the radix sort's kernels
// (radix_sort.cu: K7a, K7b; K6a runs a copy of rank_place's sweep) and the
// MoE dispatch (moe_dispatch.cu: K3).  Why it is stable is set out in
// radix_sort.cu.  rank_pass (K3's several tiles, K7b v1) runs on a CTA of
// THREADS threads over a tile in shared memory; rank_place (K7a, K7b) on a
// CTA of NT threads over a tile held in registers.
#pragma once

#include "common.cuh"

namespace {

constexpr int THREADS = 256;   // the CTA size of every rank routine
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_DIGIT = 0xffffffffu;  // an invalid lane's match key

// u32 shifts as the reference's uint32 arithmetic gives them: a shift by
// 32 or more leaves no bits (C++ leaves it undefined)
__device__ __forceinline__ unsigned shl(unsigned w, int s) {
  return s >= 32 ? 0u : w << s;
}
__device__ __forceinline__ unsigned shr(unsigned w, int s) {
  return s >= 32 ? 0u : w >> s;
}

// Exclusive scan in place of a[0, size) (shared memory) by the whole CTA;
// returns the total.  ws: shared scratch of WARPS + 1 ints.
__device__ int block_exclusive_scan(int* a, int size, int* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (size + THREADS - 1) / THREADS;
  const int lo = min(size, (int)threadIdx.x * per);
  const int hi = min(size, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < WARPS ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += y;
    }
    if (lane < WARPS) ws[lane] = t;
    if (lane == 31) ws[WARPS] = t;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? ws[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  const int total = ws[WARPS];
  __syncthreads();
  return total;
}

// One stable counting pass over a tile in shared memory: every word of
// src[0, m) goes to dst[rank] by the digit (w >> shift) & (2^bits - 1).
// cnt: shared scratch of WARPS * 2^bits ints; ws: WARPS + 1 ints.  If hist
// is not null, hist[d] receives the tile's count of digit d.  Ends with
// the CTA synchronised and dst complete.
__device__ void rank_pass(const unsigned* src, unsigned* dst, int m,
                          int shift, int bits, int* cnt, int* ws,
                          int* hist) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int radix = 1 << bits;
  const unsigned mask = (unsigned)radix - 1u;
  const int chunk = (m + WARPS - 1) / WARPS;
  const int lo = min(m, warp * chunk), hi = min(m, lo + chunk);
  const unsigned below = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < WARPS * radix; i += THREADS) cnt[i] = 0;
  __syncthreads();
  // 1. per-warp digit counts, digit-major: cnt[d * WARPS + warp]
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const bool valid = i < hi;
    const unsigned d = valid ? shr(src[i], shift) & mask : NO_DIGIT;
    const unsigned peers = __match_any_sync(FULL, d);
    if (valid && (peers & below) == 0) cnt[d * WARPS + warp] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  if (hist != nullptr)
    for (int d = threadIdx.x; d < radix; d += THREADS) {
      int s = 0;
      for (int w = 0; w < WARPS; ++w) s += cnt[d * WARPS + w];
      hist[d] = s;
    }
  // 2. the first rank of every (digit, warp) segment
  block_exclusive_scan(cnt, WARPS * radix, ws);
  // 3. rank and scatter, each warp in index order over its chunk
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const bool valid = i < hi;
    const unsigned w = valid ? src[i] : 0u;
    const unsigned d = valid ? shr(w, shift) & mask : NO_DIGIT;
    const unsigned peers = __match_any_sync(FULL, d);
    const int start = valid ? cnt[d * WARPS + warp] : 0;
    __syncwarp();
    if (valid) {
      if ((peers & below) == 0) cnt[d * WARPS + warp] = start + __popc(peers);
      dst[start + __popc(peers & below)] = w;
    }
    __syncwarp();
  }
  __syncthreads();
}

// One stable pass of a tile held in registers: afterwards buf[0, tile)
// holds the tile ordered by the digit (key >> sh) & dmask, stably, and the
// CTA is synchronised.  NT threads, K keys a thread, warp-striped: warp w
// owns words [w * 32K, (w + 1) * 32K) of the tile and lane l holds word
// w * 32K + 32 s + l as key[s], so (s, lane) is index order within the
// warp's chunk; words at tile or above are masked lanes.  The digit width
// BITS is a template argument, so the ballots and the scan unroll with no
// branch on it; dmask (< 2^BITS) narrows a last pass.  Shared memory: cnt
// [NW][2^BITS] counters, wtot [NW]; after the pass cnt[d] (warp 0's row)
// is digit d's first rank.  Four CTA barriers.
template <int K, int NT, int BITS>
__device__ __forceinline__ void rank_place(const unsigned (&key)[K], int sh,
                                           unsigned dmask, int tile,
                                           unsigned* buf, int* cnt,
                                           int* wtot) {
  constexpr int NW = NT / 32, RADIX = 1 << BITS, E = NW * RADIX;
  constexpr int PER = RADIX > 32 ? RADIX / 32 : 1;   // scan entries a thread
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int first = warp * 32 * K + lane;
  int* mine = cnt + warp * RADIX;
  unsigned dg[K];
  int rank[K];
#pragma unroll
  for (int s = 0; s < K; ++s) dg[s] = (key[s] >> sh) & dmask;
  for (int d = lane; d < RADIX; d += 32) mine[d] = 0;
  __syncwarp();
  // 1. one sweep of ballots: each key's offset among the equal digits
  // before it in the warp's chunk, and the (digit, warp) counts in `mine`.
  // Every lane reads its digit's count, then the lowest lane of each digit
  // advances it.  (The form where that lane alone reads the count and
  // shuffles it to its peers, K7a's before, gave wrong counts in one build
  // of K6a.)
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
  // 2. the first rank of every (digit, warp) segment: an exclusive scan of
  // the counts in digit-major order, entry e = d * NW + w; thread t scans
  // entries [t * PER, (t + 1) * PER) in registers, the CTA the totals
  const int e0 = threadIdx.x * PER;
  int v[PER], sum = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = e0 + i;
    v[i] = e < E ? cnt[(e % NW) * RADIX + e / NW] : 0;
    sum += v[i];
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
#pragma unroll
  for (int w = 0; w < NW - 1; ++w)
    if (w < warp) run += wtot[w];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = e0 + i;
    if (e < E) cnt[(e % NW) * RADIX + e / NW] = run;
    run += v[i];
  }
  __syncthreads();
  // 3. every key to its rank
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (first + 32 * s < tile) buf[mine[dg[s]] + rank[s]] = key[s];
  }
  __syncthreads();
}

}  // namespace
