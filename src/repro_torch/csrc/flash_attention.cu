// K1: GQA flash attention forward for Hopper (sm_90a), causal or not, with a
// query offset for chunked prefill.
//
// Replaces: repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel), which computes the same function as the serving path's
// jnp blockwise_attention / plain_attention (repro/models/attention.py).
//
// What bounds it on this card: a prefill chunk of c queries at offset P
// against its causal window does about 4*c*(P + c/2)*hd*H FLOPs on
// (2*c*H + 2*(P + c)*KV)*hd elements, so a chunk of 256 is bound by
// arithmetic (past ~295 FLOPs per byte in bf16), a chunk of 32 by bytes.
//
// Two kernels compute it, chosen by a shape rule in the Python wrapper:
//
// v3, flash_fwd_tc_kernel<HDK, HDV> (bf16; q/k head dim HDK, v head dim
// HDV: one dim, a multiple of 16 up to 128, or MLA's (192, 128)): both
// products on the bf16 tensor cores (mma.sync.aligned.m16n8k16,
// fp32 accumulation; mma.sync rather than wgmma because at these sizes --
// at most ~1024 packed rows by 2048 keys per kv head -- occupancy and
// latency bound the kernel before the tensor-core rate does, and its
// fragments are registers a warp owns).  One CTA of 4 warps serves one kv
// head: its 64 rows are (query, q head of the group) pairs packed
// query-major (row R = i * G + g), so K/V are read once per group and not
// once per q head, and each row's causal bound is its own query position
// q_offset + R / G (G need not divide 64; the last tile is ragged).  K/V
// tiles of 64 keys go into a ring of 2 shared-memory stages by
// cp.async.cg 16-byte copies: the next tile is in flight while the
// current one is in the tensor cores, with one barrier a tile.  Shared
// memory holds bf16 rows padded by 16 bytes, so every ldmatrix (.trans
// for V) is free of bank conflicts; Q is staged in the ring's last K
// stage before the loop, so 68 KB a CTA (and 200 registers a thread at
// HD 128) let 2 CTAs share an SM.  At (192, 128) Q K^T runs 12 k-steps,
// the K stages hold 192-wide rows (25 KB) and the V stages 128-wide ones
// (17 KB): 84 KB of ring, and Q's 12 A fragments are 16 more registers a
// thread, so 2 CTAs still share an SM.  Each warp owns 16 rows: S = Q K^T
// stays in the m16n8 accumulator fragments, the softmax scale (folded
// with log2 e, for exp2f) is applied to the fp32 logits, the row max and
// sum are reduced over the 4 lanes of a quad with shuffles, and P,
// rounded to bf16, is reused in registers as the A fragment of P V (as
// FlashAttention-2 does).  Where the TPU kernel scales fp32 q and keeps P
// in fp32, this one rounds q only once (to bf16, as given) and rounds P
// to bf16: both are roundings within the bf16 tolerance.  When the row
// tiles leave SMs idle (short chunks, late offsets), the wrapper splits
// each tile's key range over nsplit CTAs, each of which writes fp32
// partials (m, l, acc) of its keys.  The splits of a tile with a tile of
// keys are its live ones, the first ceil(n_t / per) (n_t kv tiles, per a
// split).  Fused (arrive != null; the wrapper's route up to 2 splits): a
// split past the live ones exits at once, writing nothing; a live CTA
// writes its partials into the tile's own scratch (tile-major: a CTA's
// rows are contiguous, so the merger reads whole sectors in order) and
// counts its arrival on the (batch row, kv head, row tile) counter
// (arrival.cuh), and the CTA that arrives last merges the tile's rows and
// writes the bf16 output: one launch, no memset, no atomics on the data,
// so one input gives bit-identical outputs on every run.  The merge
// (merge_rows) is bound by the latency of its reads from L2 and of its
// own instructions (one warp a scheduler), so it issues its reads early:
// the weights expf(m_s - max) and 1 / max(l, 1e-30) from one round trip
// of m and l, and acc as a cp.async stream 8 chunks deep through the K/V
// ring (free by then), folded a = fmaf(acc_s, w_s, a) in split order.
// One SM a tile pulls live x 32 KB, which is why the wrapper fuses only
// up to 2 splits: past that the standalone merge (flash_fwd_merge_kernel),
// which spreads the same reads over the card, is the faster route.  It
// folds every split with the same arithmetic; an empty split adds +0
// there (weight 0, l 0, acc 0), which the fused merge adds once, so the
// two routes give the same bits.  A split that lies past a row's causal
// window gives that row m = -1e30, l = 0, acc = 0, weight 0 in the merge;
// key 0 is visible to every row and lies in split 0, so no row is empty
// and the max is always a live split's.  What holds v3 back now: every
// warp reads the whole K and V tile from shared memory through ldmatrix
// (128 KB a tile a CTA), and with one or two warps a scheduler little of
// its latency is hidden; a deeper ring (3 or 4 stages) was tried and was
// no faster.  wgmma, which reads B from shared memory once per
// warpgroup, is the next step.
//
// v2, flash_fwd_kernel (fp32, and bf16 head dims that are not a multiple
// of 16): fp32 FMAs from shared memory, no tensor cores (tensor cores in
// fp32 would be TF32, and the fp32 goldens pin exact tokens).  One CTA of
// 256 threads per (64-query tile, q head, batch row).  The TPU kernel
// carries its running max, denominator and accumulator across
// *sequential grid steps* in VMEM scratch; a Hopper grid runs in no order,
// so the carry lives inside the CTA, in registers, across a loop over
// 64-key tiles of K/V staged in shared memory (fp32).  The threads form a
// 16 x 16 grid: thread (ty, tx) owns query rows ty + 16i and, per tile,
// keys tx + 16j (i, j < 4), so each shared-memory read feeds 2 FMAs
// (register blocking; row stride hd + 1 keeps the reads free of bank
// conflicts), and output dims tx + 16e.  The row max and sum are reduced
// over the 16 lanes of a row group with shuffles.  V and the output are
// at most 128 wide; q/k rows up to 128 in one instance (113 KB of shared
// memory) and up to 192 in another (145 KB, MLA's fp32 path).
//
// Both: the kv loop stops at q_offset + the tile's last query (causal
// pruning); masked logits are -1e30, never -inf, so exp() gives exactly 0
// and pruning changes no value.  The q-head -> kv-head map is h / (H /
// KV), as in the TPU index map; ragged Sq and Sk edges are masked (keys
// past the edge are zero-filled and their logits masked), not asserted
// away.  The kernels allocate nothing: the wrapper passes the output and
// the partials.
#include "arrival.cuh"
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

// ------------------------------------------------ v2: fp32 FMA kernel

constexpr int BQ = 64;            // query rows per CTA
constexpr int BK = 64;            // keys per kv tile
constexpr int MAX_HD = 128;       // v head dim (and q/k of the narrow build)
constexpr int MAX_HDK = 192;      // q/k head dim of the wide build (MLA)
constexpr int PLD = BK + 1;       // row stride of sP
constexpr int THREADS = 256;      // a 16 x 16 thread grid
constexpr int RI = BQ / 16;       // rows per thread
constexpr int KJ = BK / 16;       // keys per thread and tile
constexpr int DE = MAX_HD / 16;   // output dims per thread

// MAXK: the widest q/k head dim the instance takes (128, or 192 for MLA's
// 128 + 64); sQ and sK rows are MAXK + 1 wide, V rows MAX_HD
template <int MAXK>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) *
         (BQ * (MAXK + 1) + BK * (MAXK + 1) + BK * MAX_HD + BQ * PLD);
}

template <typename T, int MAXK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int KV, int hd, int hdv, int causal, float scale,
                 int q_offset) {
  constexpr int LD = MAXK + 1;           // row stride of sQ and sK
  extern __shared__ float smem[];
  float* sQ = smem;                      // BQ x LD, pre-scaled
  float* sK = sQ + BQ * LD;              // BK x LD
  float* sV = sK + BK * LD;              // BK x MAX_HD
  float* sP = sV + BK * MAX_HD;          // BQ x PLD probabilities

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_row = (size_t)H * hd;   // stride between sequence positions
  const size_t kv_row = (size_t)KV * hd;
  const size_t v_row = (size_t)KV * hdv, o_row = (size_t)H * hdv;
  const T* qb = q + ((size_t)b * Sq * H + h) * hd;
  const T* kb = k + ((size_t)b * Sk * KV + kvh) * hd;
  const T* vb = v + ((size_t)b * Sk * KV + kvh) * hdv;
  T* ob = o + ((size_t)b * Sq * H + h) * hdv;
  const int hd4 = hd >> 2, hdv4 = hdv >> 2;

  // q is cast to fp32 and then scaled, as the TPU kernel does
  for (int i = tid; i < BQ * hd4; i += THREADS) {
    const int r = i / hd4, d = (i - r * hd4) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < Sq) load4(qb + (size_t)(q0 + r) * q_row + d, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) sQ[r * LD + d + e] = x[e] * scale;
  }

  int qpos[RI];                          // absolute positions of my rows
#pragma unroll
  for (int i = 0; i < RI; ++i) qpos[i] = q_offset + q0 + ty + 16 * i;
  float acc[RI][DE];
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DE; ++e) acc[i][e] = 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_offset + q_last + 1) : Sk;

  for (int k0 = 0; k0 < k_hi; k0 += BK) {
    __syncthreads();                     // previous tile fully consumed
    for (int i = tid; i < BK * hd4; i += THREADS) {
      const int j = i / hd4, d = (i - j * hd4) * 4;
      float kx[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + j < k_hi) load4(kb + (size_t)(k0 + j) * kv_row + d, kx);
#pragma unroll
      for (int e = 0; e < 4; ++e) sK[j * LD + d + e] = kx[e];
    }
    for (int i = tid; i < BK * hdv4; i += THREADS) {
      const int j = i / hdv4, d = (i - j * hdv4) * 4;
      float vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + j < k_hi) load4(vb + (size_t)(k0 + j) * v_row + d, vx);
#pragma unroll
      for (int e = 0; e < 4; ++e) sV[j * MAX_HD + d + e] = vx[e];
    }
    __syncthreads();

    // scores of my RI x KJ (row, key) pairs
    float s[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float a[RI], c[KJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < KJ; ++j) c[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    float alpha[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float tile_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = kpos < Sk && (!causal || kpos <= qpos[i]);
        s[i][j] = valid ? s[i][j] : NEG_INF;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      // the 16 threads of a row group are 16 adjacent lanes of one warp
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      const float m_new = fmaxf(m[i], tile_max);
      alpha[i] = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        sP[(ty + 16 * i) * PLD + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha[i] + psum;
      m[i] = m_new;
    }
    __syncwarp();                        // my rows' P is written by my warp

#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int e = 0; e < DE; ++e) acc[i][e] *= alpha[i];
    const int kn = min(BK, k_hi - k0);
    for (int c = 0; c < kn; ++c) {
      float p[RI], vv[DE];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = sP[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int e = 0; e < DE; ++e) vv[e] = sV[c * MAX_HD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int e = 0; e < DE; ++e) acc[i][e] = fmaf(p[i], vv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = ob + (size_t)r * o_row;
#pragma unroll
    for (int e = 0; e < DE; ++e) {
      const int d = tx + 16 * e;
      if (d < hdv) store(orow + d, acc[i][e] * inv);
    }
  }
}

// -------------------------------------------- v3: bf16 tensor-core kernel

constexpr int TC_BM = 64;                 // packed rows per CTA (16 a warp)
constexpr int TC_BN = 64;                 // keys per kv tile
constexpr int TC_MAXD = 128;
constexpr int TC_STAGES = 2;              // K/V ring
constexpr int TC_THREADS = 128;
constexpr int MERGE_THREADS = 256;

// bf16 row stride of a D-wide row in shared memory: at least TC_MAXD,
// +16 bytes (every row starts 16 bytes further round the banks: ldmatrix
// meets no conflict)
__host__ __device__ constexpr int tc_lds(int D) {
  return (D > TC_MAXD ? D : TC_MAXD) + 8;
}
// K (HDK wide) and V (HDV wide) rings; Q is staged in the last K stage
// before the loop fills it
template <int HDK, int HDV>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * (tc_lds(HDK) + tc_lds(HDV)) * TC_STAGES *
         TC_BN;
}
static_assert(TC_BM == TC_BN, "Q is staged in a K stage");
// the fused merge's m, l and weights: static shared memory for this many
// splits (20 KB; with the 68 KB ring, 2 CTAs still share an SM)
constexpr int TC_MAX_FUSED = 40;

// ------------------------------------------------- the split merge

constexpr int MERGE_STAGES = 8;     // fused merge: acc chunks in flight
constexpr int MERGE_BATCH = 16;     // fused merge: m, l loads in flight

// one split's term of the merge of 4 dims: a = fmaf(acc_s, w_s, a)
__device__ __forceinline__ void fold4(float (&a)[4], float4 x, float w) {
  a[0] = fmaf(x.x, w, a[0]);
  a[1] = fmaf(x.y, w, a[1]);
  a[2] = fmaf(x.z, w, a[2]);
  a[3] = fmaf(x.w, w, a[3]);
}

// a * inv, inv = 1 / max(l, 1e-30), 4 dims as bf16 (out 8-byte aligned:
// hd % 4 == 0)
__device__ __forceinline__ void store_quad(__nv_bfloat16* out,
                                           const float (&a)[4], float inv) {
  *reinterpret_cast<__nv_bfloat162*>(out) =
      __floats2bfloat162_rn(a[0] * inv, a[1] * inv);
  *reinterpret_cast<__nv_bfloat162*>(out + 2) =
      __floats2bfloat162_rn(a[2] * inv, a[3] * inv);
}

// The fused merge, by the CTA of a row tile that arrived last: the tile's
// nrows packed rows (R = r0 + r: query R / G, head kvh G + R % G, output
// row row0 + (R / G) H + R % G) from the first `live` of nsplit splits'
// partials, in the tile's scratch (split s, row r at s TC_BM + r; acc
// rows of HD), all read through L2.
//  1. a thread a row loads its m and l of MERGE_BATCH splits at once and
//     keeps them in shared memory, takes the max, then the weights
//     expf(m_s - max) and the denominator, in split order;
//  2. acc streams through the scratch in order, in chunks of 16 rows of
//     one split (8 KB at HD 128): each thread copies by cp.async the
//     16-byte items (4 dims of a row) it will fold into its own slots of
//     the K/V ring (free by now), MERGE_STAGES chunks ahead, and folds
//     them a = fmaf(acc_s, w_s, a), so each item sums in split order.  A
//     thread reads only what it copied, so the stream needs no barrier;
//     the slots interleave the threads, so copies and reads meet no bank
//     conflict.  (Streaming a tile's rows split by split, group by group
//     was 3x slower: one 8 KB chunk a round trip.)
template <int HD, size_t RING_BYTES>
__device__ __forceinline__ void merge_rows(
    const float* pm, const float* pl, const float* pacc,
    __nv_bfloat16* __restrict__ o, float4* ring, int r0, int nrows, int G,
    size_t row0, int H, int nsplit, int live) {
  constexpr int Q = HD / 4;                     // 4-dim items of a row
  constexpr int RG = 16;                        // rows a chunk
  constexpr int GROUPS = TC_BM / RG;
  constexpr int ITEMS = RG * Q;                 // items a chunk
  constexpr int IPT = (ITEMS + TC_THREADS - 1) / TC_THREADS;   // a thread
  static_assert(sizeof(float4) * MERGE_STAGES * IPT * TC_THREADS <=
                RING_BYTES, "the stream fits the ring");
  __shared__ float sM[TC_MAX_FUSED][TC_BM];     // m, then the weights
  __shared__ float sL[TC_MAX_FUSED][TC_BM];
  __shared__ float sInv[TC_BM];                 // 1 / max(l, 1e-30)
  __shared__ size_t sOut[TC_BM];                // output row offsets
  const int tid = threadIdx.x;
  if (tid < nrows) {                            // 1. a thread a row
    float mx = NEG_INF;
    for (int s0 = 0; s0 < live; s0 += MERGE_BATCH) {
      float mv[MERGE_BATCH], lv[MERGE_BATCH];
#pragma unroll
      for (int u = 0; u < MERGE_BATCH; ++u) {
        const int s = min(s0 + u, live - 1);    // loads without branches
        mv[u] = ld_cg(pm + s * TC_BM + tid);
        lv[u] = ld_cg(pl + s * TC_BM + tid);
      }
#pragma unroll
      for (int u = 0; u < MERGE_BATCH; ++u)
        if (s0 + u < live) {
          sM[s0 + u][tid] = mv[u];
          sL[s0 + u][tid] = lv[u];
          mx = fmaxf(mx, mv[u]);
        }
    }
    float L = 0.f;
    for (int s = 0; s < live; ++s) {
      const float w = expf(sM[s][tid] - mx);
      sM[s][tid] = w;
      L = fmaf(sL[s][tid], w, L);
    }
    if (live < nsplit) L = __fadd_rn(L, 0.f);   // the empty splits' +0
    sInv[tid] = 1.f / fmaxf(L, 1e-30f);
    const int R = r0 + tid, i = R / G;
    sOut[tid] = (row0 + (size_t)i * H + (R - i * G)) * HD;
  }
  // chunk c: split c / GROUPS, rows 16 (c % GROUPS) .. + 15 of the
  // tile, at pacc + c 16 HD: the stream reads the scratch in order
  const int nchunks = GROUPS * live;
  auto issue = [&](int c) {                     // one commit group a chunk
    if (c < nchunks) {
      const int g = c % GROUPS;
      const float* chunk = pacc + (size_t)c * RG * HD;
#pragma unroll
      for (int k = 0; k < IPT; ++k) {
        const int item = tid + k * TC_THREADS;
        const bool ok = item < ITEMS && g * RG + item / Q < nrows;
        cp_async16(smem_addr(ring + ((c % MERGE_STAGES) * IPT + k) *
                                        TC_THREADS + tid),
                   ok ? chunk + item * 4 : pacc, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < MERGE_STAGES - 1; ++c) issue(c);
  __syncthreads();                              // the weights are in

  float a[GROUPS][IPT][4] = {};                 // 2. the stream
  for (int s = 0; s < live; ++s) {
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int c = s * GROUPS + g;
      issue(c + MERGE_STAGES - 1);
      cp_async_wait<MERGE_STAGES - 1>();        // chunk c is in
#pragma unroll
      for (int k = 0; k < IPT; ++k) {
        const int item = tid + k * TC_THREADS, r = g * RG + item / Q;
        if (item < ITEMS && r < nrows)
          fold4(a[g][k],
                ring[((c % MERGE_STAGES) * IPT + k) * TC_THREADS + tid],
                sM[s][r]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int g = 0; g < GROUPS; ++g)
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int item = tid + k * TC_THREADS, r = g * RG + item / Q;
      if (item >= ITEMS || r >= nrows) continue;
      if (live < nsplit) {                      // the empty splits' +0
#pragma unroll
        for (int e = 0; e < 4; ++e) a[g][k][e] = __fadd_rn(a[g][k][e], 0.f);
      }
      store_quad(o + sOut[r] + (item % Q) * 4, a[g][k], sInv[r]);
    }
}

// Fragment layouts: tensor_core.cuh.  Two S accumulator tiles side by side
// are the A fragment of P V, so P needs no shuffle.  HDK: the q/k head dim
// (the k-steps of Q K^T), HDV: the v head dim (acc, the output, P V's
// n-tiles); equal but for MLA (192, 128).
template <int HDK, int HDV>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ pm,
                    float* __restrict__ pl, float* __restrict__ pacc,
                    unsigned* __restrict__ arrive, int Sq, int Sk, int H,
                    int KV, int causal, float scale_log2, int q_offset,
                    int nsplit) {
  constexpr int LDK = tc_lds(HDK), LDV = tc_lds(HDV);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + TC_STAGES * TC_BN * LDK;      // [stage][key][d]
  __nv_bfloat16* sQ = sK + (TC_STAGES - 1) * TC_BN * LDK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int tile = gridDim.x - 1 - blockIdx.x;  // latest rows, most keys, first
  const int kvh = blockIdx.y;
  const int B = gridDim.z / nsplit;
  const int b = blockIdx.z / nsplit, split = blockIdx.z - b * nsplit;
  const int G = H / KV;
  const int M = Sq * G;                          // packed rows of a kv head
  const int r0 = tile * TC_BM;
  const int q_last = (min(r0 + TC_BM, M) - 1) / G;
  const int k_hi = causal ? min(Sk, q_offset + q_last + 1) : Sk;
  const int n_t = (k_hi + TC_BN - 1) / TC_BN;
  const int per = (n_t + nsplit - 1) / nsplit;
  const int t_begin = split * per, t_end = min(n_t, t_begin + per);
  const int live = (n_t + per - 1) / per;        // splits with a kv tile
  if (arrive != nullptr && split >= live) return;   // fused: not live
  // fused: the tile's scratch rows, nsplit x TC_BM of them
  const size_t tile_base =
      (((size_t)b * KV + kvh) * gridDim.x + tile) * nsplit * TC_BM;
  constexpr int nk8 = HDK / 8;                   // 16-byte chunks of a row
  constexpr int nd8 = HDV / 8;
  constexpr int ndk = HDK / 16;                  // 16-wide steps over HDK
  constexpr int ndv = HDV / 16;                  // and over HDV
  const size_t k_row = (size_t)KV * HDK, v_row = (size_t)KV * HDV;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * k_row + (size_t)kvh * HDK;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * v_row + (size_t)kvh * HDV;

  // packed row R of this kv head -> its row in (B, Sq, H): q rows are HDK
  // wide, output rows HDV
  auto q_row_index = [&](int R) {
    const int i = R / G;
    return (size_t)(b * Sq + i) * H + kvh * G + (R - i * G);
  };

  // Q tile (zero rows past M): cp.async group 0
  for (int c = tid; c < TC_BM * nk8; c += TC_THREADS) {
    const int r = c / nk8, d = (c - r * nk8) * 8;
    const bool full = r0 + r < M;
    cp_async16(smem_addr(sQ + r * LDK + d),
               full ? q + q_row_index(r0 + r) * HDK + d : q, full);
  }
  auto load_kv = [&](int t, int stage) {
    __nv_bfloat16* dK = sK + stage * TC_BN * LDK;
    __nv_bfloat16* dV = sV + stage * TC_BN * LDV;
    if constexpr (HDK == HDV) {   // one loop: the one-dim instances' code
      for (int c = tid; c < TC_BN * nd8; c += TC_THREADS) {
        const int j = c / nd8, d = (c - j * nd8) * 8;
        const int key = t * TC_BN + j;
        const bool full = key < k_hi;   // past it: zero-filled and masked
        const size_t off = (size_t)(full ? key : 0) * k_row + d;
        cp_async16(smem_addr(dK + j * LDK + d), kb + off, full);
        cp_async16(smem_addr(dV + j * LDV + d), vb + off, full);
      }
    } else {
      for (int c = tid; c < TC_BN * nk8; c += TC_THREADS) {
        const int j = c / nk8, d = (c - j * nk8) * 8;
        const int key = t * TC_BN + j;
        const bool full = key < k_hi;
        cp_async16(smem_addr(dK + j * LDK + d),
                   kb + (size_t)(full ? key : 0) * k_row + d, full);
      }
      for (int c = tid; c < TC_BN * nd8; c += TC_THREADS) {
        const int j = c / nd8, d = (c - j * nd8) * 8;
        const int key = t * TC_BN + j;
        const bool full = key < k_hi;
        cp_async16(smem_addr(dV + j * LDV + d),
                   vb + (size_t)(full ? key : 0) * v_row + d, full);
      }
    }
  };
  cp_async_commit();
  // the ring's first TC_STAGES - 1 tiles: one group each (maybe empty)
#pragma unroll
  for (int i = 0; i < TC_STAGES - 1; ++i) {
    if (t_begin + i < t_end) load_kv(t_begin + i, i);
    cp_async_commit();
  }

  // my two rows: packed rows r0 + 16 warp + g4 (+ 8); a padding row takes
  // the last real row's position (it is computed, never written)
  const int wr = warp * 16;
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    qpos[h] = q_offset + min(r0 + wr + g4 + 8 * h, M - 1) / G;
  const int warp_qmin = q_offset + min(r0 + wr, M - 1) / G;

  unsigned qf[ndk][4];    // A fragments of my 16 rows of Q
  float acc[nd8][4];       // O, fp32, 16 rows x HDV
#pragma unroll
  for (int n = 0; n < nd8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};   // running max, log2-scaled units
  float l_r[2] = {0.f, 0.f};           // this lane's part of the row sums

  cp_async_wait<TC_STAGES - 1>();      // group 0: Q is in
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < ndk; ++kk)
    ldmatrix_x4(qf[kk], smem_addr(sQ + (wr + (lane & 15)) * LDK +
                                  kk * 16 + (lane >> 4) * 8));

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) % TC_STAGES;
    // TC_STAGES - 2 newer groups may still be in flight: tile t is in.
    // The barrier also ends every warp's reads of the stage refilled next
    // (the previous tile's, or Q's at the first tile)
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    if (t + TC_STAGES - 1 < t_end)
      load_kv(t + TC_STAGES - 1, (stage + TC_STAGES - 1) % TC_STAGES);
    cp_async_commit();
    const __nv_bfloat16* cK = sK + stage * TC_BN * LDK;
    const __nv_bfloat16* cV = sV + stage * TC_BN * LDV;

    // S = Q K^T: 16 rows x 64 keys a warp, 8 accumulator tiles
    float s[TC_BN / 8][4];
#pragma unroll
    for (int j = 0; j < TC_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ndk; ++kk) {
      // all fragments of the step first, then the products: the loads'
      // latency overlaps instead of stalling each mma
      unsigned bk[TC_BN / 16][4];   // keys np*16 + 0..7 (k lo, hi), 8..15
#pragma unroll
      for (int np = 0; np < TC_BN / 16; ++np)
        ldmatrix_x4(bk[np], smem_addr(cK + (np * 16 + (lane & 7) +
                                            ((lane >> 4) << 3)) * LDK +
                                      kk * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int np = 0; np < TC_BN / 16; ++np) {
        mma_bf16(s[2 * np], qf[kk], bk[np][0], bk[np][1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[np][2], bk[np][3]);
      }
    }

    // scale (log2 units) and mask: past Sk, and keys after the row's query
    const int k0 = t * TC_BN;
    const bool edge = k0 + TC_BN > Sk || (causal && k0 + TC_BN - 1 > warp_qmin);
#pragma unroll
    for (int j = 0; j < TC_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int key = k0 + j * 8 + 2 * t4 + (e & 1);
          if (key >= Sk || (causal && key > qpos[e >> 1])) x = NEG_INF;
        }
        s[j][e] = x;
      }

    // online softmax: row max over the quad, rescale, P in bf16 fragments
    float mu[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m_r[h];
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // no valid key yet: subtract 0, so masked p = exp2(-1e30) = 0
      mu[h] = mx == NEG_INF ? 0.f : mx;
      alpha[h] = exp2f(m_r[h] - mu[h]);
      m_r[h] = mx;
    }
    unsigned pf[TC_BN / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < TC_BN / 8; ++j) {
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
    for (int n = 0; n < nd8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: V^T fragments by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < TC_BN / 16; ++kk) {
      unsigned bv[ndv][4];   // dims dp*16 + 0..7 (keys lo, hi), 8..15
#pragma unroll
      for (int dp = 0; dp < ndv; ++dp)
        ldmatrix_x4_trans(bv[dp], smem_addr(cV + (kk * 16 + (lane & 7) +
                                                  ((lane >> 3) & 1) * 8) *
                                                     LDV +
                                            dp * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int dp = 0; dp < ndv; ++dp) {
        mma_bf16(acc[2 * dp], pf[kk], bv[dp][0], bv[dp][1]);
        mma_bf16(acc[2 * dp + 1], pf[kk], bv[dp][2], bv[dp][3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = r0 + wr + g4 + 8 * h;
    if (R >= M) continue;
    const size_t row = q_row_index(R);
    if (nsplit == 1) {
      const float inv = 1.f / fmaxf(l_r[h], 1e-30f);
      __nv_bfloat16* orow = o + row * HDV;
#pragma unroll
      for (int n = 0; n < nd8; ++n) {
        if (n >= nd8) break;
        const __nv_bfloat162 x = __floats2bfloat162_rn(acc[n][2 * h] * inv,
                                                       acc[n][2 * h + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t4) = x;
      }
    } else {
      // fused: tile-major scratch, this CTA's TC_BM rows contiguous (the
      // merger reads whole sectors in long runs); else (nsplit, B, Sq, H)
      const size_t prow =
          arrive != nullptr
              ? (tile_base + (size_t)split * TC_BM) + (R - r0)
              : (size_t)split * B * Sq * H + row;
      if (t4 == 0) {
        pm[prow] = m_r[h] == NEG_INF ? NEG_INF : m_r[h] * LN2;
        pl[prow] = l_r[h];
      }
      float* arow = pacc + prow * HDV;
#pragma unroll
      for (int n = 0; n < nd8; ++n) {
        if (n >= nd8) break;
        *reinterpret_cast<float2*>(arow + n * 8 + 2 * t4) =
            make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      }
    }
  }
  if (arrive == nullptr || nsplit == 1 ||
      !last_to_arrive(arrive + ((size_t)b * KV + kvh) * gridDim.x + tile,
                      live))
    return;
  merge_rows<HDV, tc_smem_bytes<HDK, HDV>()>(
      pm + tile_base, pl + tile_base, pacc + tile_base * HDV, o,
      reinterpret_cast<float4*>(smem_raw), r0, min(TC_BM, M - r0), G,
      ((size_t)b * Sq) * H + (size_t)kvh * G, H, nsplit, live);
}

// The standalone merge of the splits of each (b, query, head) row in
// split order: m = max m_s, w_s = e^(m_s - m), o = sum_s w_s acc_s *
// (1 / max(sum_s w_s l_s, 1e-30)), each sum a chain of fmaf in split
// order, as the fused merge (merge_rows) computes it.  One thread per 4 output dims.
__global__ void flash_fwd_merge_kernel(const float* __restrict__ pm,
                                       const float* __restrict__ pl,
                                       const float* __restrict__ pacc,
                                       __nv_bfloat16* __restrict__ o,
                                       int rows, int hd, int nsplit) {
  const int hd4 = hd >> 2;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * hd4) return;
  const int row = (int)(idx / hd4), d = (int)(idx - (long long)row * hd4) * 4;
  float mx = NEG_INF;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, pm[(size_t)s * rows + row]);
  float L = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < nsplit; ++s) {
    const size_t pr = (size_t)s * rows + row;
    const float w = expf(pm[pr] - mx);
    L = fmaf(pl[pr], w, L);
    fold4(a, *reinterpret_cast<const float4*>(pacc + pr * hd + d), w);
  }
  store_quad(o + (size_t)row * hd + d, a, 1.f / fmaxf(L, 1e-30f));
}

// above 48 KB of shared memory only after opting in; once per process and
// kernel, so that a launch inside a CUDA graph capture makes no non-stream
// API call
template <typename K>
cudaError_t opt_in(K kernel, size_t smem, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) done = true;
  return err;
}
// one opt-in flag an instance
template <typename T, int MAXK>
bool opted_in_fma = false;
template <int HDK, int HDV>
bool opted_in_tc = false;

template <typename T, int MAXK>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Sk, int H, int KV, int hd, int hdv,
                       int causal, float scale, int q_offset,
                       cudaStream_t stream) {
  const size_t smem = fma_smem_bytes<MAXK>();
  cudaError_t err = opt_in(flash_fwd_kernel<T, MAXK>, smem,
                           opted_in_fma<T, MAXK>);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, MAXK><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, hd, hdv,
      causal, scale, q_offset);
  return cudaGetLastError();
}

// the narrow instance up to q/k head dim 128, the wide one (148 KB of
// shared memory, one CTA an SM) above
template <typename T>
cudaError_t launch_fma_hd(const void* q, const void* k, const void* v,
                          void* o, int B, int Sq, int Sk, int H, int KV,
                          int hd, int hdv, int causal, float scale,
                          int q_offset, cudaStream_t stream) {
  return hd <= MAX_HD
             ? launch_fma<T, MAX_HD>(q, k, v, o, B, Sq, Sk, H, KV, hd, hdv,
                                     causal, scale, q_offset, stream)
             : launch_fma<T, MAX_HDK>(q, k, v, o, B, Sq, Sk, H, KV, hd, hdv,
                                      causal, scale, q_offset, stream);
}

template <int HDK, int HDV>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      void* m, void* l, void* acc, void* arrive, int B,
                      int Sq, int Sk, int H, int KV, int causal, float scale,
                      int q_offset, int nsplit, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<HDK, HDV>();
  cudaError_t err = opt_in(flash_fwd_tc_kernel<HDK, HDV>, smem,
                           opted_in_tc<HDK, HDV>);
  if (err != cudaSuccess) return err;
  const int M = Sq * (H / KV);
  dim3 grid((M + TC_BM - 1) / TC_BM, KV, B * nsplit);
  flash_fwd_tc_kernel<HDK, HDV><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(acc),
      static_cast<unsigned*>(arrive), Sq, Sk, H, KV, causal, scale * LOG2E,
      q_offset, nsplit);
  return cudaGetLastError();
}

// the head dims as template arguments: every fragment loop unrolls and
// the copy's index arithmetic is shifts.  One q/k and v head dim, or
// MLA's (192, 128); any other pair is refused
cudaError_t launch_tc_hd(const void* q, const void* k, const void* v,
                         void* o, void* m, void* l, void* acc, void* arrive,
                         int B, int Sq, int Sk, int H, int KV, int hd,
                         int hdv, int causal, float scale, int q_offset,
                         int nsplit, cudaStream_t stream) {
#define REPRO_TC_CASE(DK, DV)                                                 \
  if (hd == DK && hdv == DV)                                                  \
    return launch_tc<DK, DV>(q, k, v, o, m, l, acc, arrive, B, Sq, Sk, H, KV, \
                             causal, scale, q_offset, nsplit, stream);
  REPRO_TC_CASE(16, 16)
  REPRO_TC_CASE(32, 32)
  REPRO_TC_CASE(48, 48)
  REPRO_TC_CASE(64, 64)
  REPRO_TC_CASE(80, 80)
  REPRO_TC_CASE(96, 96)
  REPRO_TC_CASE(112, 112)
  REPRO_TC_CASE(128, 128)
  REPRO_TC_CASE(192, 128)
#undef REPRO_TC_CASE
  return cudaErrorInvalidValue;
}

// kernel_attrs after the kernel's shared-memory opt-in, if it has one
template <typename K>
cudaError_t attrs(K kernel, int threads, size_t smem, bool* opted, int* out) {
  const cudaError_t err =
      opted != nullptr ? opt_in(kernel, smem, *opted) : cudaSuccess;
  return err != cudaSuccess ? err : kernel_attrs(kernel, threads, smem, out);
}

}  // namespace

// hd: the q/k head dim, hdv: the v (and output) head dim.  tensor_cores
// = 0: v2 (fp32 or bf16, hd <= 192, hdv <= 128, nsplit 1, o written).
// tensor_cores = 1: v3 (bf16, hd == hdv a multiple of 16 up to 128, or
// (192, 128)); nsplit == 1 writes o.  nsplit > 1 with arrive (B * KV *
// row tiles counters, zero between launches; at most TC_MAX_FUSED
// splits): m, l and acc are scratch of B * KV * row tiles * nsplit * TC_BM
// rows (tile-major), and the merge into o is fused.  nsplit > 1 without
// arrive: every split's partials m, l (nsplit, B, Sq, H) and acc (nsplit,
// B, Sq, H, hdv) for flash_attention_merge; o is not touched.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* m, void* l, void* acc,
                                   void* arrive, int B, int Sq, int Sk, int H,
                                   int KV, int hd, int hdv, int causal,
                                   float scale, int q_offset, int is_bf16,
                                   int tensor_cores, int nsplit,
                                   void* stream) {
  if (hd > MAX_HDK || hdv > MAX_HD || hd % 4 != 0 || hdv % 4 != 0 ||
      H % KV != 0 || nsplit < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (!is_bf16 || B * nsplit > 65535 ||
        (nsplit > 1 && (m == nullptr || l == nullptr || acc == nullptr)) ||
        (arrive != nullptr && (o == nullptr || nsplit > TC_MAX_FUSED)))
      return (int)cudaErrorInvalidValue;
    return (int)launch_tc_hd(q, k, v, o, m, l, acc, arrive, B, Sq, Sk, H, KV,
                             hd, hdv, causal, scale, q_offset, nsplit, s);
  }
  if (nsplit != 1 || arrive != nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      is_bf16 ? launch_fma_hd<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, hd,
                                             hdv, causal, scale, q_offset, s)
              : launch_fma_hd<float>(q, k, v, o, B, Sq, Sk, H, KV, hd, hdv,
                                     causal, scale, q_offset, s);
  return (int)err;
}

// o (rows, hd) bf16 from the partials of nsplit splits; rows = B * Sq * H
extern "C" int flash_attention_merge(const void* m, const void* l,
                                     const void* acc, void* o, int rows,
                                     int hd, int nsplit, void* stream) {
  if (hd % 4 != 0 || nsplit < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)rows * (hd / 4);
  const int block = MERGE_THREADS;
  flash_fwd_merge_kernel<<<(unsigned)((threads + block - 1) / block), block,
                           0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(acc), static_cast<__nv_bfloat16*>(o), rows, hd,
      nsplit);
  return (int)cudaGetLastError();
}

// What the compiler and the occupancy calculator give each kernel:
// out[0..4] = registers a thread, local (spill) bytes a thread, static
// shared bytes, dynamic shared bytes a launch, CTAs an SM can hold.
// which: 0 = v3 flash_fwd_tc_kernel<128, 128>, 1 = v2 bf16, 2 = v2 fp32,
// 3 = merge, 4 = v3 <192, 128> (MLA), 5 = v2 fp32 at q/k dim 192, 6 = v3
// <64, 64> (whisper).
extern "C" int flash_attention_attrs(int which, int* out) {
  switch (which) {
    case 0:
      return (int)attrs(flash_fwd_tc_kernel<128, 128>, TC_THREADS,
                        tc_smem_bytes<128, 128>(), &opted_in_tc<128, 128>,
                        out);
    case 1:
      return (int)attrs(flash_fwd_kernel<__nv_bfloat16, MAX_HD>, THREADS,
                        fma_smem_bytes<MAX_HD>(),
                        &opted_in_fma<__nv_bfloat16, MAX_HD>, out);
    case 2:
      return (int)attrs(flash_fwd_kernel<float, MAX_HD>, THREADS,
                        fma_smem_bytes<MAX_HD>(), &opted_in_fma<float, MAX_HD>,
                        out);
    case 3:
      return (int)attrs(flash_fwd_merge_kernel, MERGE_THREADS, 0, nullptr,
                        out);
    case 4:
      return (int)attrs(flash_fwd_tc_kernel<192, 128>, TC_THREADS,
                        tc_smem_bytes<192, 128>(), &opted_in_tc<192, 128>,
                        out);
    case 5:
      return (int)attrs(flash_fwd_kernel<float, MAX_HDK>, THREADS,
                        fma_smem_bytes<MAX_HDK>(),
                        &opted_in_fma<float, MAX_HDK>, out);
    case 6:
      return (int)attrs(flash_fwd_tc_kernel<64, 64>, TC_THREADS,
                        tc_smem_bytes<64, 64>(), &opted_in_tc<64, 64>, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
