// One beam-search expansion step: neighbor gather + query distances + visited
// probe, with the optional tombstone mask.
//
// Replaces the TPU kernel src/repro/kernels/search_expand.py::search_expand_pallas
// (body _search_expand_kernel) in its storage variants (fp32, bf16, int8
// with the per-dimension scale/offset dequant) and its `valid` variant; the
// filter variant is not ported. Semantics: repro_torch/kernels/ref.py::search_expand_ref.
//
// One block per query; the query row is staged in shared memory.
//   * a neighbor is live when its id is >= 0 and, with the mask, its valid
//     byte is set; the byte is read before the row, so neither an empty
//     slot nor a tombstone reads a row. A dead neighbor comes out exactly
//     as an empty slot: id -1, +inf, not fresh;
//   * a live neighbor's row is read once, dequantized on the quantized rungs
//     (bitwise the plain version's rows) and its squared distance to the
//     query reduced with shuffles;
//   * eight lanes read the 8 probe slots (max(v,0) % H + l) % H of the
//     query's visited table and a ballot tells whether v is there.
// fp32 rows without a dequant (the static path) keep one warp per neighbor,
// float4 per lane. The quantized rungs give each neighbor a group of L
// lanes, one lane per 16 B of row from 8 to 32, each reading quads (four
// elements in one load): at D = 128 eight lanes own a 128-byte int8 row,
// so four neighbors share a warp and more row loads are in flight; a warp
// reads element by element when D % 4 != 0.
// Bound: the Q*R*D stored bytes of scattered neighbor-row reads per step.
#include "common.cuh"

#define HASH_PROBES 8

__global__ void search_expand_f32_kernel(const float* __restrict__ x, int n, int d,
                                         const float* __restrict__ queries,
                                         const int* __restrict__ nbrs, int r,
                                         const int* __restrict__ table, int h,
                                         const uint8_t* __restrict__ valid,
                                         int* __restrict__ out_ids,
                                         float* __restrict__ out_dists,
                                         uint8_t* __restrict__ fresh, bool vec4) {
  extern __shared__ __align__(16) float qs[];  // (D,) query
  const int64_t q = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int k = threadIdx.x; k < d; k += blockDim.x) qs[k] = queries[q * d + k];
  __syncthreads();

  const int* tab = table + q * h;
  for (int j = warp; j < r; j += nwarps) {
    const int64_t o = q * r + j;
    const int v = nbrs[o];
    bool ok = v >= 0;
    if (ok && valid != nullptr) ok = valid[min(v, n - 1)] != 0;
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

// Resident blocks asked of the compiler per SM: the quantized steps are
// latency-bound (dependent id -> mask -> row loads), so eight 256-thread
// blocks (32 registers a thread); fp32 rows with a dequant keep four.
template <typename T>
struct MinBlocks {
  static constexpr int value = sizeof(T) == 4 ? 4 : 8;
};

template <typename T, bool Q>
__global__ void __launch_bounds__(256, MinBlocks<T>::value)
    search_expand_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                         const float* __restrict__ offset, int n, int d,
                         const float* __restrict__ queries, const int* __restrict__ nbrs, int r,
                         const int* __restrict__ table, int h, const uint8_t* __restrict__ valid,
                         int* __restrict__ out_ids, float* __restrict__ out_dists,
                         uint8_t* __restrict__ fresh, bool quad, int lanes) {
  extern __shared__ __align__(16) float qs[];  // (D,) query
  const int64_t q = blockIdx.x;
  for (int k = threadIdx.x; k < d; k += blockDim.x) qs[k] = queries[q * d + k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const int group = threadIdx.x / lanes, ngroups = blockDim.x / lanes;
  const int shift = (lane / lanes) * lanes;  // the group's first bit in a warp ballot
  const unsigned gmask = lanes == 32 ? REPRO_FULL_MASK : ((1u << lanes) - 1u);
  const int* tab = table + q * h;
  // a uniform trip count: every lane reaches every ballot and shuffle
  for (int base = 0; base < r; base += ngroups) {
    const int j = base + group;
    const bool in_row = j < r;
    const int64_t o = q * r + j;
    const int v = in_row ? nbrs[o] : -1;
    bool ok = v >= 0;
    if (ok && valid != nullptr) ok = valid[min(v, n - 1)] != 0;
    float part = 0.f;
    if (ok) {
      const T* row = x + (int64_t)min(v, n - 1) * d;
      part = part_sqdist_query<Q>(qs, row, d, scale, offset, quad, sub, lanes);
    }
    const float dd = group_sum(part, lanes);
    bool seen = false;
    if (in_row && sub < HASH_PROBES) seen = tab[(max(v, 0) % h + sub) % h] == v;
    const unsigned found = (__ballot_sync(REPRO_FULL_MASK, seen) >> shift) & gmask;
    if (in_row && sub == 0) {
      out_ids[o] = ok ? v : -1;
      out_dists[o] = ok ? dd : CUDART_INF_F;
      fresh[o] = (uint8_t)(ok && found == 0u);
    }
  }
}

template <typename T>
static cudaError_t launch(const void* xv, const float* scale, const float* offset, int n, int d,
                          const float* queries, const int* nbrs, long long q, int r,
                          const int* table, int h, const uint8_t* valid, int* out_ids,
                          float* out_dists, uint8_t* fresh, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const size_t smem = (size_t)d * sizeof(float);
  if constexpr (sizeof(T) == 4) {
    if (scale == nullptr) {
      cudaError_t err = allow_smem(search_expand_f32_kernel, smem);
      if (err != cudaSuccess) return err;
      const bool vec4 = (d % 4 == 0) && aligned16(x);
      search_expand_f32_kernel<<<(unsigned)q, 256, smem, stream>>>(
          x, n, d, queries, nbrs, r, table, h, valid, out_ids, out_dists, fresh, vec4);
      return cudaGetLastError();
    }
  }
  const bool quad = rows_quad<T>(x, d, scale, offset);
  const int lanes = quad ? lanes_per_row<T>(d, true, HASH_PROBES) : 32;
  if (scale != nullptr) {
    cudaError_t err = allow_smem(search_expand_kernel<T, true>, smem);
    if (err != cudaSuccess) return err;
    search_expand_kernel<T, true><<<(unsigned)q, 256, smem, stream>>>(
        x, scale, offset, n, d, queries, nbrs, r, table, h, valid, out_ids, out_dists, fresh,
        quad, lanes);
  } else {
    cudaError_t err = allow_smem(search_expand_kernel<T, false>, smem);
    if (err != cudaSuccess) return err;
    search_expand_kernel<T, false><<<(unsigned)q, 256, smem, stream>>>(
        x, scale, offset, n, d, queries, nbrs, r, table, h, valid, out_ids, out_dists, fresh,
        quad, lanes);
  }
  return cudaGetLastError();
}

extern "C" int search_expand_launch(const void* x, int dtype, const float* scale,
                                    const float* offset, int n, int d, const float* queries,
                                    const int* nbrs, long long q, int r, const int* table, int h,
                                    const uint8_t* valid, int* out_ids, float* out_dists,
                                    uint8_t* fresh, cudaStream_t stream) {
  if (q == 0) return cudaSuccess;
  switch (dtype) {
    case REPRO_F32:
      return launch<float>(x, scale, offset, n, d, queries, nbrs, q, r, table, h, valid, out_ids,
                           out_dists, fresh, stream);
    case REPRO_BF16:
      return launch<__nv_bfloat16>(x, scale, offset, n, d, queries, nbrs, q, r, table, h, valid,
                                   out_ids, out_dists, fresh, stream);
    case REPRO_I8:
      return launch<int8_t>(x, scale, offset, n, d, queries, nbrs, q, r, table, h, valid,
                            out_ids, out_dists, fresh, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
