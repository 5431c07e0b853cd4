// Shared helpers of the hand-written kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define REPRO_FULL_MASK 0xffffffffu

// Element type codes of the launch functions' `dtype` argument
// (kernels/_build.py::DTYPE_CODES).
enum ReproDtype { REPRO_F32 = 0, REPRO_BF16 = 1, REPRO_I8 = 2 };

// ---------------------------------------------------------------------------
// The precision ladder's dequant, bitwise what kernels/ref.py::dequant_rows
// computes: widen to fp32, then a rounded multiply and a rounded add (never
// an FMA: eager PyTorch runs `* scale` and `+ offset` as two kernels).
// Q (a compile-time flag) says whether scale/offset are given; without them
// the widen alone is the value, and the fp32 kernels compile to the code
// they had before the storage variants.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

__device__ __forceinline__ float affine(float v, float s, float o) {
  return __fadd_rn(__fmul_rn(v, s), o);
}

template <bool Q, typename T>
__device__ __forceinline__ float dequant(T v, const float* scale, const float* offset, int k) {
  if constexpr (Q) return affine(widen(v), scale[k], offset[k]);
  return widen(v);
}

// Four consecutive stored elements (a "quad": 16 B of fp32, 8 B of bf16,
// 4 B of int8) in one load, widened to fp32. Lane l of a warp reading quad
// l of a row covers 128 elements per instruction, coalesced.
__device__ __forceinline__ float4 load_quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
  return make_float4(__bfloat162float(e[0]), __bfloat162float(e[1]), __bfloat162float(e[2]),
                     __bfloat162float(e[3]));
}
__device__ __forceinline__ float4 load_quad(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

// Quad c of a stored row, dequantized with the scale / offset quad of the
// same dimensions (read as float4s: consecutive lanes read consecutive
// 16 B, one L1 line per eight lanes, no shared-memory bank conflicts).
template <bool Q, typename T>
__device__ __forceinline__ float4 dequant_quad(const T* p, const float* scale, const float* offset,
                                               int c) {
  float4 v = load_quad(p + 4 * c);
  if constexpr (Q) {
    const float4 s = __ldg(reinterpret_cast<const float4*>(scale) + c);
    const float4 o = __ldg(reinterpret_cast<const float4*>(offset) + c);
    v = make_float4(affine(v.x, s.x, o.x), affine(v.y, s.y, o.y), affine(v.z, s.z, o.z),
                    affine(v.w, s.w, o.w));
  }
  return v;
}

__device__ __forceinline__ float quad_sqdist(float4 a, float4 b, float acc) {
  const float t0 = a.x - b.x, t1 = a.y - b.y, t2 = a.z - b.z, t3 = a.w - b.w;
  acc = fmaf(t0, t0, acc);
  acc = fmaf(t1, t1, acc);
  acc = fmaf(t2, t2, acc);
  return fmaf(t3, t3, acc);
}

__host__ __forceinline__ bool aligned_to(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

// Whether rows of `d` elements of T at `base` (and the fp32 scale / offset,
// when given) can be read as quads: D % 4 == 0 and every row start aligned
// to a quad.
template <typename T>
__host__ __forceinline__ bool rows_quad(const void* base, int d, const float* scale,
                                        const float* offset) {
  return d % 4 == 0 && aligned_to(base, 4 * sizeof(T)) &&
         (scale == nullptr || (aligned_to(scale, 16) && aligned_to(offset, 16)));
}

// Lanes that share one row when a kernel reads rows straight from device
// memory: one per 16 bytes of stored row with quads (8 lanes for a 128-byte
// int8 row, so four rows share a warp and more loads are in flight; each
// lane then reads several quads), one per element without, a power of two
// from `min_lanes` to 32.
template <typename T>
__host__ __forceinline__ int lanes_per_row(int d, bool quad, int min_lanes) {
  const int units = quad ? (int)((d * sizeof(T) + 15) / 16) : d;
  int l = min_lanes;
  while (l < 32 && l < units) l <<= 1;
  return l;
}

// Sum over the `lanes` lanes of an aligned lane group (every lane of the
// warp must call it; each gets its group's sum).
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(REPRO_FULL_MASK, v, off);
  return v;
}

// One lane's share of the squared distance between two stored rows a, b
// (dequantized), over the `lanes` lanes of its group (`sub` = lane in group).
template <bool Q, typename T>
__device__ __forceinline__ float part_sqdist_rows(const T* a, const T* b, int d,
                                                  const float* scale, const float* offset,
                                                  bool quad, int sub, int lanes) {
  float acc = 0.f;
  if (quad) {
    for (int c = sub; c < d / 4; c += lanes)
      acc = quad_sqdist(dequant_quad<Q>(a, scale, offset, c), dequant_quad<Q>(b, scale, offset, c),
                        acc);
  } else {
    for (int k = sub; k < d; k += lanes) {
      const float t = dequant<Q>(a[k], scale, offset, k) - dequant<Q>(b[k], scale, offset, k);
      acc = fmaf(t, t, acc);
    }
  }
  return acc;
}

// One lane's share of the squared distance between an fp32 row q (shared
// memory, 16-byte aligned) and a stored row b (dequantized).
template <bool Q, typename T>
__device__ __forceinline__ float part_sqdist_query(const float* q, const T* b, int d,
                                                   const float* scale, const float* offset,
                                                   bool quad, int sub, int lanes) {
  float acc = 0.f;
  if (quad) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int c = sub; c < d / 4; c += lanes)
      acc = quad_sqdist(q4[c], dequant_quad<Q>(b, scale, offset, c), acc);
  } else {
    for (int k = sub; k < d; k += lanes) {
      const float t = q[k] - dequant<Q>(b[k], scale, offset, k);
      acc = fmaf(t, t, acc);
    }
  }
  return acc;
}

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

// 16-byte asynchronous copies global -> shared (cp.async, sm_80+), reading
// `src_bytes` (16, or 0 to zero-fill) from `gmem`; commit / wait by group.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The current device's SM count (queried once).
static int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
