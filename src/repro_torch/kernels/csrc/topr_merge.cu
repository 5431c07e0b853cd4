// Per-row dedup + top-r-by-distance merge (the pool merge and the beam merge).
//
// Replaces the TPU kernel src/repro/kernels/topr_merge.py::topr_merge_pallas
// (body _topr_merge_kernel). Semantics: repro_torch/kernels/ref.py::topr_merge_ref.
//
// One block per row of (B, W) candidates; the row sits in shared memory.
//   1. dedup: entry i is dropped when an earlier position holds the same id
//      (each thread scans j < i for its entries);
//   2. rank: a surviving entry with a finite distance goes to output slot
//      rank = #{j : (d_j, j) < (d_i, i)} over the survivors, which is its
//      place in a stable sort by distance. Ranks are distinct, so every
//      output slot is written by one thread and the result is exact and
//      deterministic, ties going to the lower position as in the oracle;
//   3. slots past the number of survivors are filled with (-1, +inf).
// Both passes are O(W^2) comparisons on shared memory: W = 96 in the build,
// ef + R in search. Bound: shared-memory comparisons rather than the
// B*W*8 bytes read and B*r*8 written.
// NaN distances are treated as empty slots (the oracle sorts them last);
// the build and search never produce them.
#include "common.cuh"

__global__ void topr_merge_kernel(const int* __restrict__ ids, const float* __restrict__ dists,
                                  int w, int r, int* __restrict__ out_ids,
                                  float* __restrict__ out_dists) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* s_id = reinterpret_cast<int*>(smem_raw);        // (W,)
  float* s_key = reinterpret_cast<float*>(s_id + w);   // (W,)
  const int64_t row = blockIdx.x;
  const int* ids_r = ids + row * w;
  const float* d_r = dists + row * w;

  for (int i = threadIdx.x; i < w; i += blockDim.x) s_id[i] = ids_r[i];
  __syncthreads();

  // pass 1: key = distance of a surviving entry, +inf otherwise
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    const int id = s_id[i];
    bool keep = id >= 0;
    for (int j = 0; keep && j < i; ++j) keep = s_id[j] != id;
    const float dd = d_r[i];
    s_key[i] = (keep && isfinite(dd)) ? dd : CUDART_INF_F;
  }
  __syncthreads();

  // pass 2: rank the survivors and count them (uniform trip count, so
  // every thread reaches each __syncthreads_count)
  int nvalid = 0;
  for (int base = 0; base < w; base += blockDim.x) {
    const int i = base + threadIdx.x;
    bool live = false;
    if (i < w) {
      const float key = s_key[i];
      live = key != CUDART_INF_F;
      if (live) {
        int rank = 0;
        for (int j = 0; j < w; ++j) {
          const float kj = s_key[j];
          rank += (kj < key) || (kj == key && j < i);
        }
        if (rank < r) {
          out_ids[row * r + rank] = s_id[i];
          out_dists[row * r + rank] = key;
        }
      }
    }
    nvalid += __syncthreads_count(live);
  }
  for (int o = nvalid + threadIdx.x; o < r; o += blockDim.x) {
    out_ids[row * r + o] = -1;
    out_dists[row * r + o] = CUDART_INF_F;
  }
}

extern "C" int topr_merge_launch(const int* ids, const float* dists, long long b, int w, int r,
                                 int* out_ids, float* out_dists, cudaStream_t stream) {
  if (b == 0) return cudaSuccess;
  const size_t smem = (size_t)w * (sizeof(int) + sizeof(float));
  cudaError_t err = allow_smem(topr_merge_kernel, smem);
  if (err != cudaSuccess) return err;
  int threads = ((w + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  topr_merge_kernel<<<(unsigned)b, threads, smem, stream>>>(ids, dists, w, r, out_ids, out_dists);
  return cudaGetLastError();
}
