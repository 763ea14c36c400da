// Helpers shared by the port's kernels: vector loads that widen to fp32,
// stores that narrow from fp32, the masked-logit value, and the kernel
// attributes every source reports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

// masked logits are -1e30, never -inf: exp() of a masked logit minus a
// real max is exactly 0, and a fully masked block gives no inf - inf = nan
constexpr float NEG_INF = -1e30f;

// 4 consecutive elements as fp32; p is 16-byte (fp32) / 8-byte (bf16)
// aligned, which the Python wrappers check
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &x.x, sizeof(lo));
  memcpy(&hi, &x.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// What the compiler and the occupancy calculator give `kernel` launched
// with `threads` threads and `smem` dynamic shared bytes (any opt-in above
// 48 KB made first): out[0..4] = registers a thread, local (spill) bytes a
// thread, static shared bytes, dynamic shared bytes a launch, CTAs an SM
// can hold.  Every source's `*_attrs` entry point reports through this.
template <typename K>
cudaError_t kernel_attrs(K kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)smem;
  out[4] = per_sm;
  return cudaSuccess;
}

}  // namespace
