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
// arithmetic (past ~295 FLOPs per byte in bf16).  This version does its
// arithmetic as fp32 FMAs from shared memory (no tensor cores), so it is
// bound by the FMA issue rate and shared-memory bandwidth, far below the
// 989 TFLOP/s bf16 tensor-core peak; mma/wgmma with TMA comes later.
//
// Design: one CTA of 256 threads per (64-query tile, q head, batch row).
// The TPU kernel carries its running max, denominator and accumulator
// across *sequential grid steps* in VMEM scratch; a Hopper grid runs in no
// order, so the carry lives inside the CTA, in registers, across a loop
// over 64-key tiles of K/V staged in shared memory (fp32).  The threads
// form a 16 x 16 grid: thread (ty, tx) owns query rows ty + 16i and, per
// tile, keys tx + 16j (i, j < 4), so each shared-memory read feeds 2 FMAs
// (register blocking; row stride hd + 1 keeps the reads free of bank
// conflicts), and output dims tx + 16e.  The row max and sum are reduced
// over the 16 lanes of a row group with shuffles.  The kv loop stops at
// q_offset + the tile's last query (causal pruning); masked logits are
// -1e30, never -inf, so exp() gives exactly 0 and pruning changes no value.
// The q-head -> kv-head map is h / (H / KV), as in the TPU index map;
// ragged Sq and Sk edges are masked, not asserted away.
#include "common.cuh"

namespace {

constexpr int BQ = 64;            // query rows per CTA
constexpr int BK = 64;            // keys per kv tile
constexpr int MAX_HD = 128;
constexpr int LD = MAX_HD + 1;    // row stride of sQ and sK
constexpr int PLD = BK + 1;       // row stride of sP
constexpr int THREADS = 256;      // a 16 x 16 thread grid
constexpr int RI = BQ / 16;       // rows per thread
constexpr int KJ = BK / 16;       // keys per thread and tile
constexpr int DE = MAX_HD / 16;   // output dims per thread

constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * LD + BK * LD + BK * MAX_HD + BQ * PLD);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int KV, int hd, int causal, float scale, int q_offset) {
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
  const T* qb = q + ((size_t)b * Sq * H + h) * hd;
  const T* kb = k + ((size_t)b * Sk * KV + kvh) * hd;
  const T* vb = v + ((size_t)b * Sk * KV + kvh) * hd;
  T* ob = o + ((size_t)b * Sq * H + h) * hd;
  const int hd4 = hd >> 2;

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
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + j < k_hi) {
        load4(kb + (size_t)(k0 + j) * kv_row + d, kx);
        load4(vb + (size_t)(k0 + j) * kv_row + d, vx);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sK[j * LD + d + e] = kx[e];
        sV[j * MAX_HD + d + e] = vx[e];
      }
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
    T* orow = ob + (size_t)r * q_row;
#pragma unroll
    for (int e = 0; e < DE; ++e) {
      const int d = tx + 16 * e;
      if (d < hd) store(orow + d, acc[i][e] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Sk, int H, int KV, int hd, int causal,
                   float scale, int q_offset, cudaStream_t stream) {
  const size_t smem = smem_bytes();
  // above 48 KB only after opting in; once per process, so that a launch
  // inside a CUDA graph capture makes no non-stream API call
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, hd, causal,
      scale, q_offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Sk, int H,
                                   int KV, int hd, int causal, float scale,
                                   int q_offset, int is_bf16, void* stream) {
  if (hd > MAX_HD || hd % 4 != 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal,
                                      scale, q_offset, s)
              : launch<float>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale,
                              q_offset, s);
  return (int)err;
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
