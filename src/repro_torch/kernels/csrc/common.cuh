// Shared helpers of the hand-written kernels (sm_90a).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define REPRO_FULL_MASK 0xffffffffu

// Sum of one float over the 32 lanes of a warp (every lane gets the sum).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(REPRO_FULL_MASK, v, off);
  return v;
}

// Squared L2 distance between two D-float rows, reduced over one warp.
// `a` and `b` may live in global or shared memory. With vec4 (D % 4 == 0
// and both rows 16-byte aligned) each lane reads float4s.
__device__ __forceinline__ float warp_row_sqdist(const float* a, const float* b, int d,
                                                 bool vec4, int lane) {
  float acc = 0.f;
  if (vec4) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    for (int k = lane; k < (d >> 2); k += 32) {
      float4 u = a4[k], v = b4[k];
      float t0 = u.x - v.x, t1 = u.y - v.y, t2 = u.z - v.z, t3 = u.w - v.w;
      acc = fmaf(t0, t0, acc);
      acc = fmaf(t1, t1, acc);
      acc = fmaf(t2, t2, acc);
      acc = fmaf(t3, t3, acc);
    }
  } else {
    for (int k = lane; k < d; k += 32) {
      float t = a[k] - b[k];
      acc = fmaf(t, t, acc);
    }
  }
  return warp_sum(acc);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
