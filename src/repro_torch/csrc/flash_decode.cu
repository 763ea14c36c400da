// K2: split-KV flash decode for Hopper (sm_90a): per-split softmax partials
// and their merge.  bf16 (v2): one launch, the merge fused into the
// partials kernel.  fp32 (v1): the partials, then a combine launch.
//
// Replaces: repro/kernels/flash_decode.py::decode_partials (body
// _decode_kernel) together with combine_partials and the plan-tree reduce
// in flash_decode, which compute the same function as the serving path's
// jnp decode_attention (repro/models/attention.py).
//
// What bounds it on this card: one query token per (row, head) against a
// cache prefix of lengths[b] positions does 4*H*hd FLOPs per cached
// position on 2*KV*hd cache elements, about 2*H/KV FLOPs per byte (8 for
// llama3-8b in bf16), far below the ~295 FLOPs/byte at which the H100's
// tensor cores would be the limit.  So the kernel is bound by the bytes of
// K/V it reads: the least time is those bytes over 3.35 TB/s, and the
// design goal is to keep enough loads in flight to cover memory latency.
//
// Two kernels compute the partials, chosen by dtype and head dim in the
// Python wrapper (kernels/flash_decode.py::uses_tensor_cores):
//
// v2, decode_partials_tc_kernel<HD> (bf16, head dim HD a multiple of 16,
// <= 128).  One CTA of 4 warps per (kv split, kv head, batch row), as v1,
// but the split is one pass: each warp owns 32-row sub-tiles of the split
// (warp w the rows [32 (w + 4 i), 32 (w + 4 i + 1))), copies their K and V
// rows into its own shared-memory slots with 16-byte cp.async.cg (rows
// past lengths[b] zero-filled and never read), and keeps its own online
// softmax over them, so no warp waits for another until the end.  K and V
// are two copy groups: V of a sub-tile is in flight while its scores are
// computed, and the next sub-tile's K while this one's P V is summed (at
// block_k 128 a warp has one sub-tile: the whole split, 64 KB, is in
// flight at once).  Both products run on the bf16 tensor cores
// (mma.sync.aligned.m16n8k16, fp32 accumulation), with the fragment code
// of K1 v3 (flash_attention.cu): the G <= 16 query heads of the kv head are
// the 16 rows of one A tile (rows >= G zero, computed and never written),
// K comes in by ldmatrix and V by ldmatrix.trans from rows padded by 16
// bytes (no bank conflicts); the scale, folded with log2 e for exp2f, goes
// on the fp32 logits; the row max and sum are reduced over the 4 lanes of
// a quad; P, rounded to bf16, is reused in registers as the A fragment of
// P V, and l is summed from the fp32 P.  At the end the 4 warps' (m, l,
// acc) meet in their own shared memory and are merged in warp order, so
// one input gives one output bit for bit.  A row with lengths[b] <= 0
// scores every position 0 (so p = 1) and reports m = -1e30, as v1 does.
//
// v1, decode_partials_kernel<T, G> (fp32, and bf16 head dims that are not
// a multiple of 16): the CTA holds all G query heads of its kv head (G a
// template parameter, so the per-head state is exactly sized in
// registers).  A lane owns 4 consecutive dims of a row (one 8- or 16-byte
// load) and a warp walks 8 rows at a time, issuing the 8 loads before
// using any.  Scores: 4 FMAs per head and a shuffle reduction; they go to
// shared memory, where one warp per head takes the max and the exp.  PV:
// each warp accumulates its rows for all G heads in registers; the 4
// warps' sums meet in shared memory.
//
// Both: each K/V row is read from device memory once for the G heads (the
// TPU index map re-reads K/V once per q head).  Positions >= lengths[b]
// are not read at all: a split that lies wholly past lengths[b] writes m =
// -1e30, l = 0, acc = 0 without touching the cache, and masked positions of
// a split contribute exactly 0 (no -inf anywhere, so no inf - inf = nan).
// A row with lengths[b] <= 0 gives the reference's dense softmax over
// all-masked logits, the mean of V: it masks no position and scores each
// with one logit.  S need not be a multiple of block_k.  The split count is
// a function of S alone, never of B or lengths, and a CTA reads only its
// own row, so batched and one-at-a-time decode give the same bits.
//
// The merge (merge_quad, one routine for both routes).  What bounds it:
// a decode step's partials are 2 MB (B 8, 32 heads, 16 splits), 0.0007 ms
// of bytes, so a launch of its own is all latency: a host launch a layer a
// step, a device launch gap, and a dependent pass over the splits for the
// max before the pass that sums.  A thread owns 4 dims of one (row, head):
// it loads every split's m, l and 4 acc values at once (16 splits a
// batch), takes the max, then folds the splits in split order, w =
// expf(m_s - max), l and acc by fmaf, and writes acc / max(l, 1e-30) in
// the cache dtype.  The arithmetic of a dim is the same whichever kernel
// runs it, so the two routes give the same bits.
//
// Fused (v2, out != null): the merge runs in the CTA that finishes last
// among the live splits of its (batch row, kv head), those that hold a
// position below lengths[b] (all S positions for lengths[b] <= 0).  A
// live CTA writes its partials, then its thread 0 counts its arrival on
// the (row, kv head) counter with one atom.acq_rel.gpu.inc modulo the live
// count, after a CTA barrier (the release covers every thread's partials,
// the acquire the reads that follow), so the CTA that reads live - 1 is
// the last, sees every live split's partials (read through L2) and leaves
// the counter at 0 for the next launch: no memset.  A split wholly past
// lengths[b] writes its (-1e30, 0, 0) and exits without arriving: waiting
// on the atomic cost such CTAs more than the rest of their work.  The live
// splits are a prefix of the split order, and the fold's terms of an empty
// split are 0 * w = +0, which only turn a sum of -0 into +0: merge_quad
// folds the live prefix and then adds +0 once, so the fused output equals
// partials + the standalone combine over all splits bit for bit.  A launch
// that faults leaves the context unusable, so no later launch reads a
// counter it left dirty.  One counter buffer serves one stream at a time
// (two launches in flight on it would share counters); the Python wrapper
// allocates it once per device, outside any capture.
//
// Standalone (flash_decode_combine, v1 and the card checks): a grid of
// (H * hd / 4 / 128, B) CTAs, a thread a (head, 4 dims) of a batch row.
#include "arrival.cuh"
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 8;          // rows a warp has in flight
constexpr int MAX_HD = 128;      // 4 dims per lane
constexpr int MAX_BLOCK_K = 256;
constexpr int TC_SUB = 32;       // v2: cache rows a warp sub-tile
constexpr int TC_MAXG = 16;      // v2: query heads a kv head (one m16 tile)
constexpr int TC_MAXD_SLOTS = MAX_HD / 16 + 1;

template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
decode_partials_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ lengths,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       float* __restrict__ acc_out, int S, int H, int KV,
                       int hd, int block_k, int nsplit, float scale) {
  extern __shared__ float smem[];
  float* sS = smem;                  // G x block_k scores, then probabilities
  float* sRed = sS + G * block_k;    // WARPS x G x hd per-warp PV sums

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool none = lengths[b] <= 0;  // no valid position: attend all S
  const int len = none ? S : min(lengths[b], S);
  const int s0 = split * block_k;
  const int n = min(s0 + block_k, len) - s0;   // valid positions here
  const size_t kv_row = (size_t)KV * hd;
  const T* kb = k + ((size_t)b * S * KV + kvh) * hd;
  const T* vb = v + ((size_t)b * S * KV + kvh) * hd;
  // output (B, H, nsplit) and (B, H, nsplit, hd) for head h = kvh*G + g
  const size_t out0 = ((size_t)b * H + (size_t)kvh * G) * nsplit + split;

  if (n <= 0) {                      // wholly past lengths[b]: no cache read
    for (int g = 0; g < G; ++g) {
      if (tid == 0) {
        m_out[out0 + (size_t)g * nsplit] = NEG_INF;
        l_out[out0 + (size_t)g * nsplit] = 0.f;
      }
      for (int d = tid; d < hd; d += THREADS)
        acc_out[(out0 + (size_t)g * nsplit) * hd + d] = 0.f;
    }
    return;
  }

  const int d0 = 4 * lane;           // this lane's 4 dims
  const bool has_d = d0 < hd;
  float qr[G][4];                    // q of the G heads, cast then scaled
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (has_d) {
      load4(q + ((size_t)b * H + (size_t)kvh * G + g) * hd + d0, qr[g]);
#pragma unroll
      for (int i = 0; i < 4; ++i) qr[g][i] *= scale;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) qr[g][i] = 0.f;
    }
  }

  // scores: warp w takes rows [w*ROWS, w*ROWS + ROWS) of every
  // WARPS*ROWS-row stride, all ROWS loads issued before the first use
  for (int jb = warp * ROWS; jb < n; jb += WARPS * ROWS) {
    float kr[ROWS][4];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (jb + u < n && has_d) {
        load4(kb + (size_t)(s0 + jb + u) * kv_row + d0, kr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) kr[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) x = fmaf(qr[g][i], kr[u][i], x);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        if (lane == 0 && jb + u < n)
          sS[g * block_k + jb + u] = none ? NEG_INF : x;
      }
    }
  }
  __syncthreads();

  // per head: max, exp, sum — one warp per head
  for (int g = warp; g < G; g += WARPS) {
    float* sg = sS + g * block_k;
    float mx = NEG_INF;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sg[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(sg[j] - mx);
      sg[j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m_out[out0 + (size_t)g * nsplit] = mx;
      l_out[out0 + (size_t)g * nsplit] = sum;
    }
  }
  __syncthreads();

  // acc[g][d] = sum_j p[g][j] * v[j][d]: each warp its rows, V read once
  // for all G heads
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
  for (int jb = warp * ROWS; jb < n; jb += WARPS * ROWS) {
    float vr[ROWS][4];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (jb + u < n && has_d) {
        load4(vb + (size_t)(s0 + jb + u) * kv_row + d0, vr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) vr[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (jb + u < n) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = sS[g * block_k + jb + u];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[g][i] = fmaf(p, vr[u][i], acc[g][i]);
        }
      }
    }
  }
  if (has_d) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) sRed[(warp * G + g) * hd + d0 + i] = acc[g][i];
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += THREADS) {
    const int g = i / hd, d = i - g * hd;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += sRed[(w * G + g) * hd + d];
    acc_out[(out0 + (size_t)g * nsplit) * hd + d] = s;
  }
}

// ------------------------------------------------------ the merge

constexpr int MERGE_BATCH = 16;  // splits whose loads are in flight at once

// The LSE merge of the nsplit partials of one (row, head) for its dims
// d0 .. d0 + 3: m and l point at its nsplit values, acc at its [nsplit][hd]
// block, out at its hd outputs.  Splits from nlive on are empty (-1e30,
// 0, 0): they add +0 each, once for all (see the note at the top).  Loads
// go through L2 (ld_cg): in the fused route other CTAs wrote them during
// this launch.  acc + d0 is 16-byte aligned (hd % 4 == 0, checked by the
// callers).
template <typename T>
__device__ __forceinline__ void merge_quad(const float* __restrict__ m,
                                           const float* __restrict__ l,
                                           const float* __restrict__ acc,
                                           T* __restrict__ out, int hd,
                                           int nsplit, int nlive, int d0) {
  float mx = NEG_INF;
  if (nlive > MERGE_BATCH)
    for (int s = 0; s < nlive; ++s) mx = fmaxf(mx, ld_cg(m + s));
  float lsum = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < nlive; s0 += MERGE_BATCH) {
    float mv[MERGE_BATCH], lv[MERGE_BATCH];
    float4 av[MERGE_BATCH];
#pragma unroll
    for (int u = 0; u < MERGE_BATCH; ++u)
      if (s0 + u < nlive) {
        mv[u] = ld_cg(m + s0 + u);
        lv[u] = ld_cg(l + s0 + u);
        av[u] = ld_cg4(acc + (size_t)(s0 + u) * hd + d0);
      }
    if (nlive <= MERGE_BATCH) {
#pragma unroll
      for (int u = 0; u < MERGE_BATCH; ++u)
        if (u < nlive) mx = fmaxf(mx, mv[u]);
    }
#pragma unroll
    for (int u = 0; u < MERGE_BATCH; ++u)
      if (s0 + u < nlive) {
        const float w = expf(mv[u] - mx);
        lsum = fmaf(lv[u], w, lsum);
        a[0] = fmaf(av[u].x, w, a[0]);
        a[1] = fmaf(av[u].y, w, a[1]);
        a[2] = fmaf(av[u].z, w, a[2]);
        a[3] = fmaf(av[u].w, w, a[3]);
      }
  }
  if (nlive < nsplit) {              // the empty splits' +0 (lsum >= +0)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = __fadd_rn(a[i], 0.f);
  }
  const float den = fmaxf(lsum, 1e-30f);
#pragma unroll
  for (int i = 0; i < 4; ++i) store(out + d0 + i, a[i] / den);
}

// ------------------------------------------ v2: bf16 tensor-core kernel

template <int HD>
constexpr size_t tc_smem_bytes() {   // a K and a V slot for every warp
  return sizeof(__nv_bfloat16) * (size_t)WARPS * 2 * TC_SUB * (HD + 8);
}

// Fragment layouts: tensor_core.cuh.  Rows of the A tile are the query
// heads of the kv head.
template <int HD>
__global__ void __launch_bounds__(THREADS, 3)
decode_partials_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ lengths,
                          float* __restrict__ m_out, float* __restrict__ l_out,
                          float* __restrict__ acc_out, int S, int H, int KV,
                          int block_k, int nsplit, float scale_log2,
                          __nv_bfloat16* __restrict__ out,
                          unsigned* __restrict__ arrive) {
  constexpr int LDS = HD + 8;        // bf16 row stride: +16 bytes
  constexpr int nd8 = HD / 8;        // 16-byte chunks of a row; n8 tiles
  constexpr int ndk = HD / 16;       // k steps of Q K^T, 16-wide dim pairs
  constexpr int NT = TC_SUB / 8;     // n8 tiles of scores a sub-tile
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int G = H / KV;
  const bool none = lengths[b] <= 0;  // no valid position: attend all S
  const int len = none ? S : min(lengths[b], S);
  const int s0 = split * block_k;
  const int n = min(s0 + block_k, len) - s0;   // valid positions here
  const size_t out0 = ((size_t)b * H + (size_t)kvh * G) * nsplit + split;
  // fused: the last live CTA of the (row, kv head) merges its G heads
  auto finish = [&]() {
    const int live = (len + block_k - 1) / block_k;   // splits with n > 0
    if (out == nullptr ||
        !last_to_arrive(arrive + (size_t)b * KV + kvh, live))
      return;
    const size_t row0 = (size_t)b * H + (size_t)kvh * G;
    for (int i = tid; i < G * (HD / 4); i += THREADS) {
      const int g = i / (HD / 4), d0 = (i - g * (HD / 4)) * 4;
      const size_t r = row0 + g;
      merge_quad(m_out + r * nsplit, l_out + r * nsplit,
                 acc_out + r * nsplit * HD, out + r * HD, HD, nsplit, live,
                 d0);
    }
  };

  if (n <= 0) {                      // wholly past lengths[b]: no cache read
    for (int g = 0; g < G; ++g) {
      if (tid == 0) {
        m_out[out0 + (size_t)g * nsplit] = NEG_INF;
        l_out[out0 + (size_t)g * nsplit] = 0.f;
      }
      for (int d = tid; d < HD; d += THREADS)
        acc_out[(out0 + (size_t)g * nsplit) * HD + d] = 0.f;
    }
    return;                          // and does not arrive
  }

  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw) +
                      (size_t)warp * 2 * TC_SUB * LDS;
  __nv_bfloat16* sV = sK + TC_SUB * LDS;
  const size_t kv_row = (size_t)KV * HD;
  const size_t first_row = ((size_t)b * S + s0) * KV + kvh;
  const __nv_bfloat16* kb = k + first_row * HD;
  const __nv_bfloat16* vb = v + first_row * HD;

  // one sub-tile's rows [j0, j0 + 32) of the split into a slot; rows past
  // n are zero-filled from no address (row 0 stands in, never read)
  auto load = [&](const __nv_bfloat16* src, __nv_bfloat16* dst, int j0) {
#pragma unroll 4
    for (int c = lane; c < TC_SUB * nd8; c += 32) {
      const int r = c / nd8, d = (c - r * nd8) * 8;
      const bool full = j0 + r < n;
      cp_async16(smem_addr(dst + r * LDS + d),
                 src + (full ? (size_t)(j0 + r) * kv_row : 0) + d, full);
    }
  };
  int j0 = warp * TC_SUB;            // this warp's first sub-tile
  const int step = WARPS * TC_SUB;
  if (j0 < n) {
    load(kb, sK, j0);
    cp_async_commit();
    load(vb, sV, j0);
    cp_async_commit();
  }

  // A fragments of Q: heads g4 and g4 + 8 of the kv head, zero past G
  unsigned qf[ndk][4];
  const __nv_bfloat16* qh = q + ((size_t)b * H + (size_t)kvh * G) * HD;
#pragma unroll
  for (int kk = 0; kk < ndk; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g4 + 8 * h;
      const __nv_bfloat16* p = qh + (size_t)row * HD + kk * 16 + 2 * t4;
      qf[kk][h] = row < G ? *reinterpret_cast<const unsigned*>(p) : 0u;
      qf[kk][h + 2] = row < G ? *reinterpret_cast<const unsigned*>(p + 8) : 0u;
    }

  float acc[nd8][4];                 // this warp's P V, fp32, 16 rows x HD
#pragma unroll
  for (int nn = 0; nn < nd8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};   // running max, log2-scaled units
  float l_r[2] = {0.f, 0.f};           // this lane's part of the row sums

  for (; j0 < n; j0 += step) {
    const bool more = j0 + step < n;
    cp_async_wait<1>();              // K of this sub-tile is in
    __syncwarp();

    // S = Q K^T: 16 rows x 32 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ndk; ++kk) {
      unsigned bk[NT / 2][4];        // keys np*16 + 0..7 (k lo, hi), 8..15
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldmatrix_x4(bk[np], smem_addr(sK + (np * 16 + (lane & 7) +
                                            ((lane >> 4) << 3)) * LDS +
                                      kk * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        mma_bf16(s[2 * np], qf[kk], bk[np][0], bk[np][1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[np][2], bk[np][3]);
      }
    }
    __syncwarp();                    // every lane is done with the K slot
    if (more) load(kb, sK, j0 + step);
    cp_async_commit();               // (maybe empty) keeps the count fixed

    // scale (log2 units) and mask past n; a row with no valid position
    // scores every position 0
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + j * 8 + 2 * t4 + (e & 1);
        s[j][e] = key >= n ? NEG_INF : none ? 0.f : s[j][e] * scale_log2;
      }

    // online softmax over the warp's sub-tiles: row max over the quad,
    // rescale, P in bf16 fragments
    float mu[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m_r[h];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mu[h] = mx == NEG_INF ? 0.f : mx;
      alpha[h] = exp2f(m_r[h] - mu[h]);
      m_r[h] = mx;
    }
    unsigned pf[NT / 2][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = exp2f(s[j][0] - mu[0]), p1 = exp2f(s[j][1] - mu[0]);
      const float p2 = exp2f(s[j][2] - mu[1]), p3 = exp2f(s[j][3] - mu[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * alpha[h] + rs[h];
#pragma unroll
    for (int nn = 0; nn < nd8; ++nn) {
      acc[nn][0] *= alpha[0];
      acc[nn][1] *= alpha[0];
      acc[nn][2] *= alpha[1];
      acc[nn][3] *= alpha[1];
    }

    cp_async_wait<1>();              // V of this sub-tile is in
    __syncwarp();
    // O += P V: V^T fragments by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < ndk; ++dp) {
        unsigned bv[4];              // dims dp*16 + 0..7 (keys lo, hi), 8..15
        ldmatrix_x4_trans(bv, smem_addr(sV + (kk * 16 + (lane & 7) +
                                              ((lane >> 3) & 1) * 8) * LDS +
                                        dp * 16 + (lane >> 4) * 8));
        mma_bf16(acc[2 * dp], pf[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pf[kk], bv[2], bv[3]);
      }
    }
    __syncwarp();                    // every lane is done with the V slot
    if (more) load(vb, sV, j0 + step);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // the warps' partials meet in shared memory, each warp in its own slots
  // (its reads of them are over): m, l of 16 rows, then acc [16][HD + 4]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
  }
  constexpr int ALD = HD + 4;
  float* wm = reinterpret_cast<float*>(sK);
  float* wl = wm + TC_MAXG;
  float* wacc = wl + TC_MAXG;
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g4 + 8 * h;
    if (row < G) {
      if (t4 == 0) {
        wm[row] = m_r[h];
        wl[row] = l_r[h];
      }
#pragma unroll
      for (int nn = 0; nn < nd8; ++nn)
        *reinterpret_cast<float2*>(wacc + row * ALD + nn * 8 + 2 * t4) =
            make_float2(acc[nn][2 * h], acc[nn][2 * h + 1]);
    }
  }
  __syncthreads();
  // merge in warp order: m = max m_w, weights 2^(m_w - m); m reported in
  // natural-log units, and -1e30 for a row with no valid position
  constexpr size_t WSTRIDE = 2 * TC_SUB * LDS / 2;   // floats a warp's slots
  const float* m0 = reinterpret_cast<const float*>(smem_raw);
  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i - g * HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m0[w * WSTRIDE + g]);
    const float mu = mx == NEG_INF ? 0.f : mx;
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* base = m0 + w * WSTRIDE;
      const float wt = exp2f(base[g] - mu);
      a = fmaf(wt, base[2 * TC_MAXG + g * ALD + d], a);
      lsum = fmaf(wt, base[TC_MAXG + g], lsum);
    }
    const size_t o = out0 + (size_t)g * nsplit;
    acc_out[o * HD + d] = a;
    if (d == 0) {
      m_out[o] = none || mx == NEG_INF ? NEG_INF : mx * LN2;
      l_out[o] = lsum;
    }
  }
  finish();
}

// a thread a (head, 4 dims) of batch row blockIdx.y
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ m, const float* __restrict__ l,
                      const float* __restrict__ acc, T* __restrict__ out,
                      int H, int hd, int nsplit) {
  const int quads = hd / 4;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= H * quads) return;
  const int h = i / quads, d0 = (i - h * quads) * 4;
  const size_t r = (size_t)blockIdx.y * H + h;
  merge_quad(m + r * nsplit, l + r * nsplit, acc + r * nsplit * hd,
             out + r * hd, hd, nsplit, nsplit, d0);
}

template <typename T, int G>
cudaError_t launch_partials(const void* q, const void* k, const void* v,
                            const int* lengths, float* m, float* l, float* acc,
                            int B, int S, int H, int KV, int hd, int block_k,
                            int nsplit, float scale, cudaStream_t stream) {
  // at most 16 * (MAX_BLOCK_K + WARPS * MAX_HD) floats = 48 KB: what a
  // launch may take without opting in to more
  const size_t smem = sizeof(float) * G * (size_t)(block_k + WARPS * hd);
  dim3 grid(nsplit, KV, B);
  decode_partials_kernel<T, G><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, m, l, acc, S, H, KV, hd, block_k,
      nsplit, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_partials(const void* q, const void* k, const void* v,
                            const int* lengths, float* m, float* l, float* acc,
                            int B, int S, int H, int KV, int hd, int block_k,
                            int nsplit, float scale, cudaStream_t stream) {
  switch (H / KV) {
    case 1: return launch_partials<T, 1>(q, k, v, lengths, m, l, acc, B, S, H, KV, hd, block_k, nsplit, scale, stream);
    case 2: return launch_partials<T, 2>(q, k, v, lengths, m, l, acc, B, S, H, KV, hd, block_k, nsplit, scale, stream);
    case 3: return launch_partials<T, 3>(q, k, v, lengths, m, l, acc, B, S, H, KV, hd, block_k, nsplit, scale, stream);
    case 4: return launch_partials<T, 4>(q, k, v, lengths, m, l, acc, B, S, H, KV, hd, block_k, nsplit, scale, stream);
    case 5: return launch_partials<T, 5>(q, k, v, lengths, m, l, acc, B, S, H, KV, hd, block_k, nsplit, scale, stream);
    case 8: return launch_partials<T, 8>(q, k, v, lengths, m, l, acc, B, S, H, KV, hd, block_k, nsplit, scale, stream);
    case 16: return launch_partials<T, 16>(q, k, v, lengths, m, l, acc, B, S, H, KV, hd, block_k, nsplit, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// above 48 KB of shared memory only after opting in; once per process and
// head dim, so that a launch inside a CUDA graph capture makes no
// non-stream API call
bool opted_in_tc[TC_MAXD_SLOTS] = {};

template <int HD>
cudaError_t opt_in_tc() {
  if (opted_in_tc[HD / 16]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      decode_partials_tc_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tc_smem_bytes<HD>());
  if (err == cudaSuccess) opted_in_tc[HD / 16] = true;
  return err;
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const int* lengths, float* m, float* l, float* acc,
                      __nv_bfloat16* out, unsigned* arrive, int B, int S,
                      int H, int KV, int block_k, int nsplit, float scale,
                      cudaStream_t stream) {
  const cudaError_t err = opt_in_tc<HD>();
  if (err != cudaSuccess) return err;
  dim3 grid(nsplit, KV, B);
  decode_partials_tc_kernel<HD><<<grid, THREADS, tc_smem_bytes<HD>(),
                                  stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, m, l, acc, S, H, KV,
      block_k, nsplit, scale * LOG2E, out, arrive);
  return cudaGetLastError();
}

// the head dim as a template argument: every fragment loop unrolls
cudaError_t launch_tc_hd(const void* q, const void* k, const void* v,
                         const int* lengths, float* m, float* l, float* acc,
                         __nv_bfloat16* out, unsigned* arrive, int B, int S,
                         int H, int KV, int hd, int block_k, int nsplit,
                         float scale, cudaStream_t stream) {
#define REPRO_TC_CASE(D)                                                    \
  case D:                                                                   \
    return launch_tc<D>(q, k, v, lengths, m, l, acc, out, arrive, B, S, H,  \
                        KV, block_k, nsplit, scale, stream);
  switch (hd) {
    REPRO_TC_CASE(16)
    REPRO_TC_CASE(32)
    REPRO_TC_CASE(48)
    REPRO_TC_CASE(64)
    REPRO_TC_CASE(80)
    REPRO_TC_CASE(96)
    REPRO_TC_CASE(112)
    REPRO_TC_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_TC_CASE
}

}  // namespace

// tensor_cores = 1: v2 (bf16, hd % 16 == 0, H / KV <= 16); 0: v1 (bf16 or
// fp32, H / KV one of the template's groups).  out (B, H, hd) bf16 and
// arrive (B * KV unsigned counters, zero between launches) non-null: v2
// with the merge fused (one launch); null: the partials alone.
extern "C" int flash_decode_partials(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* m, void* l, void* acc, void* out,
                                     void* arrive, int B, int S, int H,
                                     int KV, int hd, int block_k, int nsplit,
                                     float scale, int is_bf16,
                                     int tensor_cores, void* stream) {
  if (hd > MAX_HD || hd % 4 != 0 || H % KV != 0 || block_k < 1 ||
      block_k > MAX_BLOCK_K || (long long)nsplit * block_k < S ||
      (out == nullptr) != (arrive == nullptr) ||
      (out != nullptr && !tensor_cores))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
  if (tensor_cores) {
    if (!is_bf16 || hd % 16 != 0 || H / KV > TC_MAXG)
      return (int)cudaErrorInvalidValue;
    return (int)launch_tc_hd(q, k, v, len, mf, lf, af,
                             static_cast<__nv_bfloat16*>(out),
                             static_cast<unsigned*>(arrive), B, S, H, KV, hd,
                             block_k, nsplit, scale, s);
  }
  cudaError_t err =
      is_bf16 ? launch_partials<__nv_bfloat16>(q, k, v, len, mf, lf, af, B, S, H,
                                               KV, hd, block_k, nsplit, scale, s)
              : launch_partials<float>(q, k, v, len, mf, lf, af, B, S, H, KV,
                                       hd, block_k, nsplit, scale, s);
  return (int)err;
}

extern "C" int flash_decode_combine(const void* m, const void* l,
                                    const void* acc, void* out, int B, int H,
                                    int hd, int nsplit, int is_bf16,
                                    void* stream) {
  if (nsplit < 1 || hd < 4 || hd % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((H * (hd / 4) + THREADS - 1) / THREADS, B);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  const float* af = static_cast<const float*>(acc);
  if (is_bf16)
    decode_combine_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        mf, lf, af, static_cast<__nv_bfloat16*>(out), H, hd, nsplit);
  else
    decode_combine_kernel<float><<<grid, THREADS, 0, s>>>(
        mf, lf, af, static_cast<float*>(out), H, hd, nsplit);
  return (int)cudaGetLastError();
}

// What the compiler and the occupancy calculator give each kernel:
// out[0..4] = registers a thread, local (spill) bytes a thread, static
// shared bytes, dynamic shared bytes a launch, CTAs an SM can hold.
// which: 0 = v2 decode_partials_tc_kernel<128> (with the fused merge), 1 =
// v1 bf16 at G = 4, 2 = v1 fp32 at G = 4, 3 = combine (bf16 out), 4 = v2
// decode_partials_tc_kernel<64> (whisper's head dim).
extern "C" int flash_decode_attrs(int which, int* out) {
  switch (which) {
    case 0: {
      const cudaError_t err = opt_in_tc<128>();
      if (err != cudaSuccess) return (int)err;
      return (int)kernel_attrs(decode_partials_tc_kernel<128>, THREADS,
                               tc_smem_bytes<128>(), out);
    }
    case 1:
      return (int)kernel_attrs(decode_partials_kernel<__nv_bfloat16, 4>,
                               THREADS,
                               sizeof(float) * 4 * (size_t)(128 + WARPS * 128),
                               out);
    case 2:
      return (int)kernel_attrs(decode_partials_kernel<float, 4>, THREADS,
                               sizeof(float) * 4 * (size_t)(128 + WARPS * 128),
                               out);
    case 3:
      return (int)kernel_attrs(decode_combine_kernel<__nv_bfloat16>, THREADS,
                               0, out);
    case 4: {
      const cudaError_t err = opt_in_tc<64>();
      if (err != cudaSuccess) return (int)err;
      return (int)kernel_attrs(decode_partials_tc_kernel<64>, THREADS,
                               tc_smem_bytes<64>(), out);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
