// K2: split-KV flash decode for Hopper (sm_90a): per-split softmax partials
// plus one combine launch.
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
// Design, partials (flash_decode_partials): one CTA of 4 warps per
// (kv split, kv head, batch row).  The CTA holds all G = H/KV query heads
// of its kv head (G is a template parameter, so the per-head state is
// exactly sized in registers), so each K/V row is read from device memory
// once for the G heads (the TPU index map re-reads K/V once per q head).
// A lane owns 4 consecutive dims of a row (one 8- or 16-byte load) and a
// warp walks 8 rows at a time, issuing the 8 loads before using any, so
// each warp keeps 8 rows of K (then V) in flight.  Scores: 4 FMAs per head
// and a shuffle reduction; they go to shared memory, where one warp per
// head takes the max and the exp.  PV: each warp accumulates its rows for
// all G heads in registers; the 4 warps' sums meet in shared memory.
// Positions >= lengths[b] are not read at all: a split that lies wholly
// past lengths[b] writes m = -1e30, l = 0, acc = 0 without touching the
// cache, and masked positions of a split contribute exactly 0 (no -inf
// anywhere, so no inf - inf = nan).  A row with lengths[b] <= 0 gives the
// reference's dense softmax over all-masked logits, the mean of V: it
// masks no position and scores each with the same logit -1e30 (one branch
// at the score store, no extra pass).  S need not be a multiple of block_k.
// The split count is a function of S alone, never of B or lengths, so
// batched and one-at-a-time decode sum in the same order.
//
// Design, combine (flash_decode_combine): one CTA per (head, batch row);
// each thread owns one output dim and does the LSE merge over all splits
// against their common max, then acc / max(l, 1e-30), cast to the cache
// dtype.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 8;          // rows a warp has in flight
constexpr int MAX_HD = 128;      // 4 dims per lane
constexpr int MAX_BLOCK_K = 256;

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ m, const float* __restrict__ l,
                      const float* __restrict__ acc, T* __restrict__ out,
                      int H, int hd, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t base = ((size_t)b * H + h) * nsplit;
  float mx = NEG_INF;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, m[base + s]);
  for (int d = threadIdx.x; d < hd; d += THREADS) {
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(m[base + s] - mx);
      lsum = fmaf(l[base + s], w, lsum);
      a = fmaf(acc[(base + s) * hd + d], w, a);
    }
    store(out + ((size_t)b * H + h) * hd + d, a / fmaxf(lsum, 1e-30f));
  }
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
    case 4: return launch_partials<T, 4>(q, k, v, lengths, m, l, acc, B, S, H, KV, hd, block_k, nsplit, scale, stream);
    case 5: return launch_partials<T, 5>(q, k, v, lengths, m, l, acc, B, S, H, KV, hd, block_k, nsplit, scale, stream);
    case 8: return launch_partials<T, 8>(q, k, v, lengths, m, l, acc, B, S, H, KV, hd, block_k, nsplit, scale, stream);
    case 16: return launch_partials<T, 16>(q, k, v, lengths, m, l, acc, B, S, H, KV, hd, block_k, nsplit, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_decode_partials(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* m, void* l, void* acc, int B, int S,
                                     int H, int KV, int hd, int block_k,
                                     int nsplit, float scale, int is_bf16,
                                     void* stream) {
  if (hd > MAX_HD || hd % 4 != 0 || H % KV != 0 || block_k < 1 ||
      block_k > MAX_BLOCK_K || (long long)nsplit * block_k < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
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
  if (nsplit < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(H, B);
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

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
