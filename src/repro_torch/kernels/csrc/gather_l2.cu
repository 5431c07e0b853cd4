// Paired squared distances over gathered rows: out[m] = |x[ni[m]] - x[nj[m]]|^2.
//
// Replaces the TPU kernel src/repro/kernels/gather_l2.py::gather_sqdist_pallas
// (body _gather_l2_kernel). Semantics: repro_torch/kernels/ref.py::gather_sqdist_ref.
//
// The TPU kernel steps an (M,) grid and DMAs the two rows of each pair into
// VMEM by scalar-prefetched index. Here a group of L lanes owns one pair:
//   * each lane reads quads (four elements in one load: 4 B of int8, 8 B of
//     bf16, 16 B of fp32), and a group has one lane per 16 B of row, 8 to
//     32: at D = 128 eight lanes own a 128-byte int8 row (four pairs share a
//     warp, four quads per lane), a whole warp a 512-byte fp32 row; rows
//     with D % 4 != 0 (D = 33) are read element by element by a warp;
//   * indices are clamped to [0, N-1] in the kernel and row offsets are
//     int64 (ni * D overflows int32 past 2^31 elements);
//   * both rows are dequantized with the scale / offset quads of the same
//     dimensions (float4 loads that L1 serves; bitwise the plain version's
//     rows) and the group reduces with xor shuffles. Whether to dequantize
//     is a template flag, so the float rungs carry no dequant code.
// Bound: bytes. Counted once per input, the store, ni, nj and the output
// (~0.65 GB at M = 43.2M over a (2^20, 128) int8 tier); the kernel reads
// 2*M rows (11 GB of int8 rows), mostly re-reads of rows shared between
// pools, which L2 may catch. No (M, D) gather is ever materialized.
#include "common.cuh"

template <typename T, bool Q>
__global__ void __launch_bounds__(256)
gather_sqdist_kernel(const T* __restrict__ x, long long n, int d, const int* __restrict__ ni,
                     const int* __restrict__ nj, long long m, const float* __restrict__ scale,
                     const float* __restrict__ offset, float* __restrict__ out, bool quad,
                     int lanes) {
  const int sub = (threadIdx.x & 31) & (lanes - 1);
  const long long pair = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / lanes;
  const bool live = pair < m;  // every lane stays for the shuffles below
  float acc = 0.f;
  if (live) {
    const long long a = min(max((long long)ni[pair], 0ll), n - 1);
    const long long b = min(max((long long)nj[pair], 0ll), n - 1);
    acc = part_sqdist_rows<Q>(x + a * d, x + b * d, d, scale, offset, quad, sub, lanes);
  }
  acc = group_sum(acc, lanes);
  if (live && sub == 0) out[pair] = acc;
}

template <typename T>
static cudaError_t launch(const void* xv, long long n, int d, const int* ni, const int* nj,
                          long long m, const float* scale, const float* offset, float* out,
                          cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const bool quad = rows_quad<T>(x, d, scale, offset);
  const int lanes = quad ? lanes_per_row<T>(d, true, 8) : 32;
  const long long blocks = (m * lanes + 255) / 256;
  if (scale != nullptr)
    gather_sqdist_kernel<T, true><<<(unsigned)blocks, 256, 0, stream>>>(x, n, d, ni, nj, m, scale,
                                                                       offset, out, quad, lanes);
  else
    gather_sqdist_kernel<T, false><<<(unsigned)blocks, 256, 0, stream>>>(
        x, n, d, ni, nj, m, scale, offset, out, quad, lanes);
  return cudaGetLastError();
}

extern "C" int gather_sqdist_launch(const void* x, int dtype, long long n, int d, const int* ni,
                                    const int* nj, long long m, const float* scale,
                                    const float* offset, float* out, cudaStream_t stream) {
  if (m == 0) return cudaSuccess;
  if (n <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case REPRO_F32:
      return launch<float>(x, n, d, ni, nj, m, scale, offset, out, stream);
    case REPRO_BF16:
      return launch<__nv_bfloat16>(x, n, d, ni, nj, m, scale, offset, out, stream);
    case REPRO_I8:
      return launch<int8_t>(x, n, d, ni, nj, m, scale, offset, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
