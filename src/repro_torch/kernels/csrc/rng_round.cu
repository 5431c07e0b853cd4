// One disordered GRNND propagation round (paper Alg. 4 lines 4-10).
//
// Replaces the TPU kernel src/repro/kernels/rng_round.py::rng_round_pallas
// (body _rng_round_kernel). Semantics: repro_torch/kernels/ref.py::rng_round_ref.
//
// One block per vertex v of the (C, R) pool chunk:
//   1. its R pool rows x[ids[v, s]] are copied once into shared memory
//      (R*D*4 bytes: 24 KB at R = 48, D = 128), as the TPU kernel keeps them
//      in VMEM: a row touched by several sampled pairs is read from device
//      memory once;
//   2. each warp takes sampled pairs q = warp, warp + 8, ...: the lanes sum
//      (x[ni] - x[nj])^2 over D from shared memory and reduce with shuffles;
//      lane 0 applies the RNG criterion dij < max(dvi, dvj) on valid pairs
//      (both slots full, distinct ids) and writes dst / src / dij;
//   3. a hit sets the farther endpoint's kill flag in shared memory (a plain
//      store of 1: OR is order-free, so the result is deterministic); the
//      flags are written out after a barrier.
// Bound: the R*D*4 bytes of pool rows per vertex (gathered rows, mostly
// from device memory and L2); the P*D FMAs per vertex are far below the
// card's fp32 rate.
#include "common.cuh"

__global__ void rng_round_kernel(const float* __restrict__ x, int n, int d,
                                 const int* __restrict__ ids, const float* __restrict__ dists,
                                 const int* __restrict__ si, const int* __restrict__ sj, int r,
                                 int p, int* __restrict__ dst, int* __restrict__ src,
                                 float* __restrict__ dij, uint8_t* __restrict__ kill, bool vec4) {
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
    const float* xr = x + (int64_t)id * d;
    float* row = rows + (size_t)s * d;
    if (vec4) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      float4* r4 = reinterpret_cast<float4*>(row);
      for (int k = lane; k < (d >> 2); k += 32) r4[k] = x4[k];
    } else {
      for (int k = lane; k < d; k += 32) row[k] = xr[k];
    }
  }
  __syncthreads();

  for (int q = warp; q < p; q += nwarps) {
    const int64_t o = v * p + q;
    const int a = min(max(si[o], 0), r - 1);
    const int b = min(max(sj[o], 0), r - 1);
    const float dd = warp_row_sqdist(rows + (size_t)a * d, rows + (size_t)b * d, d, vec4, lane);
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

extern "C" int rng_round_launch(const float* x, int n, int d, const int* ids, const float* dists,
                                const int* si, const int* sj, long long c, int r, int p, int* dst,
                                int* src, float* dij, uint8_t* kill, cudaStream_t stream) {
  if (c == 0) return cudaSuccess;
  const size_t smem = (size_t)r * d * sizeof(float) + (size_t)r * sizeof(int);
  cudaError_t err = allow_smem(rng_round_kernel, smem);
  if (err != cudaSuccess) return err;
  const bool vec4 = (d % 4 == 0) && aligned16(x);
  rng_round_kernel<<<(unsigned)c, 256, smem, stream>>>(x, n, d, ids, dists, si, sj, r, p, dst, src,
                                                       dij, kill, vec4);
  return cudaGetLastError();
}
