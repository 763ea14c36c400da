// The last-CTA merge shared by the fused K2 v2 (flash_decode.cu) and the
// fused K1 v3 split merge (flash_attention.cu): every CTA of a group
// writes its partials, counts its arrival on the group's counter, and the
// CTA that arrives last reads all the group's partials through L2.
#pragma once

#include <cuda_runtime.h>

namespace {

// loads through L2 (ld.global.cg), volatile and with a memory clobber so
// that the compiler keeps them after the arrival barrier
__device__ __forceinline__ float ld_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];\n" : "=f"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_cg4(const float* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

// This CTA has arrived at its group's counter, which counts modulo
// `live`: true in the CTA that arrives last.  One atom.acq_rel.gpu.inc by
// thread 0 after a CTA barrier: the release covers every thread's
// partials, the acquire (with the barrier after it) the reads that follow;
// the live-th arrival reads live - 1 and leaves the counter at 0 for the
// next launch, with no memset.
__device__ __forceinline__ bool last_to_arrive(unsigned* counter, int live) {
  __shared__ unsigned arrived;
  __syncthreads();                   // every thread's partials are written
  if (threadIdx.x == 0)
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;\n"
                 : "=r"(arrived)
                 : "l"(counter), "r"((unsigned)live - 1u)
                 : "memory");
  __syncthreads();
  return arrived == (unsigned)live - 1u;
}

}  // namespace
