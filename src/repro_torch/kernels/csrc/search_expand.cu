// One beam-search expansion step: neighbor gather + query distances + visited probe.
//
// Replaces the TPU kernel src/repro/kernels/search_expand.py::search_expand_pallas
// (body _search_expand_kernel), fp32, unfiltered, without the tombstone mask.
// Semantics: repro_torch/kernels/ref.py::search_expand_ref.
//
// One block per query; the query row is staged in shared memory. Each warp
// takes neighbors j = warp, warp + 8, ... of the query's (R,) row:
//   * a live neighbor's row is read once from device memory (float4 per lane
//     when D % 4 == 0) and its squared distance to the query is reduced
//     with shuffles; an empty slot (-1) reads nothing;
//   * lanes 0..7 read the 8 probe slots (max(v,0) % H + l) % H of the
//     query's visited table and a ballot tells whether v is there.
// Bound: the Q*R*D*4 bytes of scattered neighbor-row reads per step.
#include "common.cuh"

#define HASH_PROBES 8

__global__ void search_expand_kernel(const float* __restrict__ x, int n, int d,
                                     const float* __restrict__ queries,
                                     const int* __restrict__ nbrs, int r,
                                     const int* __restrict__ table, int h,
                                     int* __restrict__ out_ids, float* __restrict__ out_dists,
                                     uint8_t* __restrict__ fresh, bool vec4) {
  extern __shared__ __align__(16) float qs[];  // (D,)
  const int64_t q = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int k = threadIdx.x; k < d; k += blockDim.x) qs[k] = queries[q * d + k];
  __syncthreads();

  const int* tab = table + q * h;
  for (int j = warp; j < r; j += nwarps) {
    const int64_t o = q * r + j;
    const int v = nbrs[o];
    const bool ok = v >= 0;
    float dd = CUDART_INF_F;
    if (ok) dd = warp_row_sqdist(qs, x + (int64_t)min(v, n - 1) * d, d, vec4, lane);
    bool seen = false;
    if (lane < HASH_PROBES) seen = tab[(max(v, 0) % h + lane) % h] == v;
    const unsigned found = __ballot_sync(REPRO_FULL_MASK, seen);
    if (lane == 0) {
      out_ids[o] = ok ? v : -1;
      out_dists[o] = dd;
      fresh[o] = (uint8_t)(ok && found == 0u);
    }
  }
}

extern "C" int search_expand_launch(const float* x, int n, int d, const float* queries,
                                    const int* nbrs, long long q, int r, const int* table, int h,
                                    int* out_ids, float* out_dists, uint8_t* fresh,
                                    cudaStream_t stream) {
  if (q == 0) return cudaSuccess;
  const size_t smem = (size_t)d * sizeof(float);
  cudaError_t err = allow_smem(search_expand_kernel, smem);
  if (err != cudaSuccess) return err;
  const bool vec4 = (d % 4 == 0) && aligned16(x);
  search_expand_kernel<<<(unsigned)q, 256, smem, stream>>>(x, n, d, queries, nbrs, r, table, h,
                                                           out_ids, out_dists, fresh, vec4);
  return cudaGetLastError();
}
