// Squared L2 distances: all pairs (pairwise_sqdist) and corresponding rows
// (rowwise_sqdist). pairwise takes either side stored at fp32, bf16 or int8
// with its own per-dimension scale/offset; rowwise is fp32.
//
// pairwise_sqdist replaces src/repro/kernels/pairwise_l2.py::pairwise_sqdist_pallas
// (body _pairwise_kernel); rowwise_sqdist replaces
// src/repro/kernels/pairwise_l2.py::rowwise_sqdist_pallas (body _rowwise_kernel).
// Semantics: repro_torch/kernels/ref.py::{pairwise,rowwise}_sqdist_ref.
//
// pairwise: a shared-memory tiled GEMM on the fp32 FMA units (never TF32:
// two fp32 implementations already differ by up to 7.3e-4 at D = 960).
// A 256-thread block owns a 64x64 output tile; each thread a 4x4 register
// tile. Per k-slab of 16, both 64x16 input tiles are staged transposed in
// shared memory; every thread reads a float4 of each and does 16 FMAs. The
// row norms |x|^2 and |y|^2 are summed from the same staged tiles, so no
// second pass over the inputs is needed, and the epilogue writes
// max(|x|^2 + |y|^2 - 2 x.y, 0). A quantized side is dequantized while its
// tile is staged (bitwise the plain version's rows), so the norms come from
// the dequantized values; the kernel is templated on both sides' element
// types and on whether any side carries a scale / offset, so the fp32 path
// carries no dequant code. Bound: 2*M*N*D flops at the fp32 rate (67 TFLOP/s) for the
// ground-truth shapes; the M*N*4 output bytes come second.
//
// rowwise: one warp per row pair, float4 loads, a shuffle reduction. Bound:
// the 2*M*D*4 input bytes.
#include "common.cuh"

constexpr int BM = 64, BN = 64, BK = 16, PAD = 4;

template <typename TX, typename TY, bool Q>
__global__ void __launch_bounds__(256)
pairwise_kernel(const TX* __restrict__ x, const float* __restrict__ xsc,
                const float* __restrict__ xof, const TY* __restrict__ y,
                const float* __restrict__ ysc, const float* __restrict__ yof, int m, int n, int d,
                float* __restrict__ out) {
  __shared__ __align__(16) float xs[BK][BM + PAD];
  __shared__ __align__(16) float ys[BK][BN + PAD];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t m0 = (int64_t)blockIdx.y * BM, n0 = (int64_t)blockIdx.x * BN;
  float acc[4][4] = {};
  float xx[4] = {}, yy[4] = {};

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int e = tid; e < BM * BK; e += 256) {
      const int row = e / BK, kk = e % BK, k = k0 + kk;
      const int64_t gm = m0 + row, gn = n0 + row;
      float xv = 0.f, yv = 0.f;
      if (gm < m && k < d) {
        xv = widen(x[gm * d + k]);
        if (Q && xsc != nullptr) xv = affine(xv, xsc[k], xof[k]);
      }
      if (gn < n && k < d) {
        yv = widen(y[gn * d + k]);
        if (Q && ysc != nullptr) yv = affine(yv, ysc[k], yof[k]);
      }
      xs[kk][row] = xv;
      ys[kk][row] = yv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&ys[kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xx[i] = fmaf(a[i], a[i], xx[i]);
        yy[i] = fmaf(b[i], b[i], yy[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t gm = m0 + ty * 4 + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t gn = n0 + tx * 4 + j;
      if (gn < n) out[gm * n + gn] = fmaxf(xx[i] + yy[j] - 2.f * acc[i][j], 0.f);
    }
  }
}

__global__ void rowwise_kernel(const float* __restrict__ x, const float* __restrict__ y,
                               long long m, int d, float* __restrict__ out, bool vec4) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= m) return;  // warp-uniform
  const float dd = warp_row_sqdist(x + row * d, y + row * d, d, vec4, lane);
  if (lane == 0) out[row] = dd;
}

template <typename TX, typename TY>
static cudaError_t pairwise(const void* x, const float* xsc, const float* xof, const void* y,
                            const float* ysc, const float* yof, int m, int n, int d, float* out,
                            cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const TX* xt = static_cast<const TX*>(x);
  const TY* yt = static_cast<const TY*>(y);
  if (xsc != nullptr || ysc != nullptr)
    pairwise_kernel<TX, TY, true><<<grid, 256, 0, stream>>>(xt, xsc, xof, yt, ysc, yof, m, n, d,
                                                            out);
  else
    pairwise_kernel<TX, TY, false><<<grid, 256, 0, stream>>>(xt, xsc, xof, yt, ysc, yof, m, n, d,
                                                             out);
  return cudaGetLastError();
}

template <typename TX>
static cudaError_t pairwise_y(const void* x, const float* xsc, const float* xof, const void* y,
                              int ydt, const float* ysc, const float* yof, int m, int n, int d,
                              float* out, cudaStream_t stream) {
  switch (ydt) {
    case REPRO_F32:
      return pairwise<TX, float>(x, xsc, xof, y, ysc, yof, m, n, d, out, stream);
    case REPRO_BF16:
      return pairwise<TX, __nv_bfloat16>(x, xsc, xof, y, ysc, yof, m, n, d, out, stream);
    case REPRO_I8:
      return pairwise<TX, int8_t>(x, xsc, xof, y, ysc, yof, m, n, d, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int pairwise_sqdist_launch(const void* x, int xdt, const float* xsc, const float* xof,
                                      const void* y, int ydt, const float* ysc, const float* yof,
                                      int m, int n, int d, float* out, cudaStream_t stream) {
  if (m == 0 || n == 0) return cudaSuccess;
  switch (xdt) {
    case REPRO_F32:
      return pairwise_y<float>(x, xsc, xof, y, ydt, ysc, yof, m, n, d, out, stream);
    case REPRO_BF16:
      return pairwise_y<__nv_bfloat16>(x, xsc, xof, y, ydt, ysc, yof, m, n, d, out, stream);
    case REPRO_I8:
      return pairwise_y<int8_t>(x, xsc, xof, y, ydt, ysc, yof, m, n, d, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int rowwise_sqdist_launch(const float* x, const float* y, long long m, int d,
                                     float* out, cudaStream_t stream) {
  if (m == 0) return cudaSuccess;
  const bool vec4 = (d % 4 == 0) && aligned16(x) && aligned16(y);
  const long long blocks = (m + 7) / 8;
  rowwise_kernel<<<(unsigned)blocks, 256, 0, stream>>>(x, y, m, d, out, vec4);
  return cudaGetLastError();
}
