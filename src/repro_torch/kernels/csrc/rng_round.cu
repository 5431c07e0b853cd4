// One disordered GRNND propagation round (paper Alg. 4 lines 4-10).
//
// Replaces the TPU kernel src/repro/kernels/rng_round.py::rng_round_pallas
// (body _rng_round_kernel). Semantics: repro_torch/kernels/ref.py::rng_round_ref.
//
// Templated on the stored element type (fp32, bf16, int8 with the
// per-dimension scale/offset dequant). One block per vertex v of the (C, R)
// pool chunk:
//   1. its R pool rows x[ids[v, s]] are copied once into shared memory as
//      dequantized fp32 (R*D*4 bytes: 24 KB at R = 48, D = 128), as the TPU
//      kernel keeps them in VMEM: a row touched by several sampled pairs is
//      read from device memory once, a warp per row, each lane one quad
//      (four elements in one load) written as one float4, so the shared
//      stores are free of bank conflicts; the dequant is bitwise the plain
//      version's and a template flag, so fp32 rows carry no dequant code;
//   2. each warp takes sampled pairs q = warp, warp + 8, ...: the lanes sum
//      (x[ni] - x[nj])^2 over D from shared memory and reduce with shuffles;
//      lane 0 applies the RNG criterion dij < max(dvi, dvj) on valid pairs
//      (both slots full, distinct ids) and writes dst / src / dij;
//   3. a hit sets the farther endpoint's kill flag in shared memory (a plain
//      store of 1: OR is order-free, so the result is deterministic); the
//      flags are written out after a barrier.
// Bound: the R*D stored bytes of pool rows per vertex (gathered rows,
// mostly from device memory and L2); the P*D FMAs per vertex are far below
// the card's fp32 rate.
#include "common.cuh"

template <typename T, bool Q>
__global__ void rng_round_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                 const float* __restrict__ offset, int n, int d,
                                 const int* __restrict__ ids, const float* __restrict__ dists,
                                 const int* __restrict__ si, const int* __restrict__ sj, int r,
                                 int p, int* __restrict__ dst, int* __restrict__ src,
                                 float* __restrict__ dij, uint8_t* __restrict__ kill, bool quad) {
  extern __shared__ __align__(16) float smem[];
  float* rows = smem;                                            // (R, D)
  int* kill_s = reinterpret_cast<int*>(smem + (size_t)r * d);    // (R,)
  const int64_t v = blockIdx.x;
  const int* ids_v = ids + v * r;
  const float* dists_v = dists + v * r;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;

  for (int s = threadIdx.x; s < r; s += blockDim.x) kill_s[s] = 0;
  for (int s = warp; s < r; s += nwarps) {
    const int id = min(max(ids_v[s], 0), n - 1);
    load_row_f32<Q>(x + (int64_t)id * d, rows + (size_t)s * d, d, scale, offset, quad, lane);
  }
  __syncthreads();

  for (int q = warp; q < p; q += nwarps) {
    const int64_t o = v * p + q;
    const int a = min(max(si[o], 0), r - 1);
    const int b = min(max(sj[o], 0), r - 1);
    const float dd = warp_row_sqdist(rows + (size_t)a * d, rows + (size_t)b * d, d, d % 4 == 0, lane);
    if (lane == 0) {
      const int ni = ids_v[a], nj = ids_v[b];
      const float dvi = dists_v[a], dvj = dists_v[b];
      const bool valid = ni >= 0 && nj >= 0 && ni != nj;
      const bool hit = valid && dd < fmaxf(dvi, dvj);
      const bool i_far = dvi > dvj;
      dst[o] = hit ? (i_far ? nj : ni) : -1;
      src[o] = i_far ? ni : nj;
      dij[o] = dd;
      if (hit) kill_s[i_far ? a : b] = 1;
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < r; s += blockDim.x) kill[v * r + s] = (uint8_t)kill_s[s];
}

template <typename T>
static cudaError_t launch(const void* xv, const float* scale, const float* offset, int n, int d,
                          const int* ids, const float* dists, const int* si, const int* sj,
                          long long c, int r, int p, int* dst, int* src, float* dij,
                          uint8_t* kill, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const size_t smem = (size_t)r * d * sizeof(float) + (size_t)r * sizeof(int);
  const bool quad = rows_quad<T>(x, d, scale, offset);
  if (scale != nullptr) {
    cudaError_t err = allow_smem(rng_round_kernel<T, true>, smem);
    if (err != cudaSuccess) return err;
    rng_round_kernel<T, true><<<(unsigned)c, 256, smem, stream>>>(
        x, scale, offset, n, d, ids, dists, si, sj, r, p, dst, src, dij, kill, quad);
  } else {
    cudaError_t err = allow_smem(rng_round_kernel<T, false>, smem);
    if (err != cudaSuccess) return err;
    rng_round_kernel<T, false><<<(unsigned)c, 256, smem, stream>>>(
        x, scale, offset, n, d, ids, dists, si, sj, r, p, dst, src, dij, kill, quad);
  }
  return cudaGetLastError();
}

extern "C" int rng_round_launch(const void* x, int dtype, const float* scale, const float* offset,
                                int n, int d, const int* ids, const float* dists, const int* si,
                                const int* sj, long long c, int r, int p, int* dst, int* src,
                                float* dij, uint8_t* kill, cudaStream_t stream) {
  if (c == 0) return cudaSuccess;
  switch (dtype) {
    case REPRO_F32:
      return launch<float>(x, scale, offset, n, d, ids, dists, si, sj, c, r, p, dst, src, dij,
                           kill, stream);
    case REPRO_BF16:
      return launch<__nv_bfloat16>(x, scale, offset, n, d, ids, dists, si, sj, c, r, p, dst, src,
                                   dij, kill, stream);
    case REPRO_I8:
      return launch<int8_t>(x, scale, offset, n, d, ids, dists, si, sj, c, r, p, dst, src, dij,
                            kill, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
