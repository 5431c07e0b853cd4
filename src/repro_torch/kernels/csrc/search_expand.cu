// One beam-search expansion step: neighbor gather + query distances + visited
// probe, with the optional tombstone mask and label predicate.
//
// Replaces the TPU kernel src/repro/kernels/search_expand.py::search_expand_pallas
// (body _search_expand_kernel) in its storage variants (fp32, bf16, int8
// with the per-dimension scale/offset dequant), its `valid` variant and its
// filter variant. Semantics: repro_torch/kernels/ref.py::search_expand_ref.
//
// One block per query; the query row is staged in shared memory, and with
// the filter (a compile-time flag F) the query's W predicate words after it.
//   * a neighbor is live when its id is >= 0 and, with the mask, its valid
//     byte is set; the byte is read before the row, so neither an empty
//     slot nor a tombstone reads a row. A dead neighbor comes out exactly
//     as an empty slot: id -1, +inf, not fresh;
//   * a live neighbor's row is read once, dequantized on the quantized rungs
//     (bitwise the plain version's rows) and its squared distance to the
//     query reduced with shuffles;
//   * eight lanes read the 8 probe slots (max(v,0) % H + l) % H of the
//     query's visited table and a ballot tells whether v is there;
//   * with the filter, a live neighbor's lanes read its W label words once
//     (int4 loads when W % 4 == 0 and the words are 16-byte aligned, single
//     words otherwise), AND them with the staged query words, and a ballot
//     folds the result: allowed = live && any word intersects. ids, dists
//     and fresh are computed as without the filter (route-through); a dead
//     or empty slot reads no words and is not allowed.
// fp32 rows without a dequant (the static path) keep one warp per neighbor,
// float4 per lane. The quantized rungs give each neighbor a group of L
// lanes, one lane per 16 B of row from 8 to 32, each reading quads (four
// elements in one load): at D = 128 eight lanes own a 128-byte int8 row,
// so four neighbors share a warp and more row loads are in flight; a warp
// reads element by element when D % 4 != 0.
// Bound: the Q*R*D stored bytes of scattered neighbor-row reads per step
// (plus Q*R*W*4 label-word bytes with the filter).
#include "common.cuh"

#define HASH_PROBES 8

// Whether any of the W label words of one neighbor intersects the query's
// staged predicate words `fw`: this lane's share, over `lanes` lanes
// (`sub` = lane in its group). quad = int4 loads.
__device__ __forceinline__ bool part_label_hit(const int* __restrict__ vw, const int* fw, int w,
                                               bool quad, int sub, int lanes) {
  bool hit = false;
  if (quad) {
    const int4* v4 = reinterpret_cast<const int4*>(vw);
    for (int c = sub; c < w / 4; c += lanes) {
      const int4 a = __ldg(v4 + c);
      hit |= ((a.x & fw[4 * c]) | (a.y & fw[4 * c + 1]) | (a.z & fw[4 * c + 2]) |
              (a.w & fw[4 * c + 3])) != 0;
    }
  } else {
    for (int k = sub; k < w; k += lanes) hit |= (__ldg(vw + k) & fw[k]) != 0;
  }
  return hit;
}

// Stage the query row (D floats) and, with the filter, its W predicate
// words right after it in shared memory.
template <bool F>
__device__ __forceinline__ void stage_query(float* qs, const float* __restrict__ queries,
                                            const int* __restrict__ fwords, int64_t q, int d,
                                            int w) {
  for (int k = threadIdx.x; k < d; k += blockDim.x) qs[k] = queries[q * d + k];
  if constexpr (F) {
    int* fw = reinterpret_cast<int*>(qs + d);
    for (int k = threadIdx.x; k < w; k += blockDim.x) fw[k] = fwords[q * w + k];
  }
  __syncthreads();
}

template <bool F>
__global__ void search_expand_f32_kernel(const float* __restrict__ x, int n, int d,
                                         const float* __restrict__ queries,
                                         const int* __restrict__ nbrs, int r,
                                         const int* __restrict__ table, int h,
                                         const uint8_t* __restrict__ valid,
                                         const int* __restrict__ vwords,
                                         const int* __restrict__ fwords, int w,
                                         int* __restrict__ out_ids,
                                         float* __restrict__ out_dists,
                                         uint8_t* __restrict__ fresh,
                                         uint8_t* __restrict__ allowed, bool vec4, bool wquad) {
  extern __shared__ __align__(16) float qs[];  // (D,) query, then (W,) words
  const int64_t q = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  stage_query<F>(qs, queries, fwords, q, d, w);

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
    unsigned hits = 0u;
    if constexpr (F) {
      bool hit = false;
      if (ok)
        hit = part_label_hit(vwords + (int64_t)min(v, n - 1) * w,
                             reinterpret_cast<const int*>(qs + d), w, wquad, lane, 32);
      hits = __ballot_sync(REPRO_FULL_MASK, hit);
    }
    if (lane == 0) {
      out_ids[o] = ok ? v : -1;
      out_dists[o] = dd;
      fresh[o] = (uint8_t)(ok && found == 0u);
      if constexpr (F) allowed[o] = (uint8_t)(ok && hits != 0u);
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

template <typename T, bool Q, bool F>
__global__ void __launch_bounds__(256, MinBlocks<T>::value)
    search_expand_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                         const float* __restrict__ offset, int n, int d,
                         const float* __restrict__ queries, const int* __restrict__ nbrs, int r,
                         const int* __restrict__ table, int h, const uint8_t* __restrict__ valid,
                         const int* __restrict__ vwords, const int* __restrict__ fwords, int w,
                         int* __restrict__ out_ids, float* __restrict__ out_dists,
                         uint8_t* __restrict__ fresh, uint8_t* __restrict__ allowed, bool quad,
                         int lanes, bool wquad) {
  extern __shared__ __align__(16) float qs[];  // (D,) query, then (W,) words
  const int64_t q = blockIdx.x;
  stage_query<F>(qs, queries, fwords, q, d, w);

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
    unsigned hits = 0u;
    if constexpr (F) {
      bool hit = false;
      if (ok)
        hit = part_label_hit(vwords + (int64_t)min(v, n - 1) * w,
                             reinterpret_cast<const int*>(qs + d), w, wquad, sub, lanes);
      hits = (__ballot_sync(REPRO_FULL_MASK, hit) >> shift) & gmask;
    }
    if (in_row && sub == 0) {
      out_ids[o] = ok ? v : -1;
      out_dists[o] = ok ? dd : CUDART_INF_F;
      fresh[o] = (uint8_t)(ok && found == 0u);
      if constexpr (F) allowed[o] = (uint8_t)(ok && hits != 0u);
    }
  }
}

// One launch of the kernel that fits the rung: fp32 rows without a dequant
// keep the warp-per-neighbor kernel, the rest the lane-group kernel; F (the
// filter) is a template flag, so the filter-free instantiations are the
// code they were before it.
template <typename T, bool F>
static cudaError_t launch(const void* xv, const float* scale, const float* offset, int n, int d,
                          const float* queries, const int* nbrs, long long q, int r,
                          const int* table, int h, const uint8_t* valid, const int* vwords,
                          const int* fwords, int w, int* out_ids, float* out_dists,
                          uint8_t* fresh, uint8_t* allowed, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const size_t smem = (size_t)d * sizeof(float) + (F ? (size_t)w * sizeof(int) : 0);
  const bool wquad = F && w % 4 == 0 && aligned16(vwords);
  if constexpr (sizeof(T) == 4) {
    if (scale == nullptr) {
      cudaError_t err = allow_smem(search_expand_f32_kernel<F>, smem);
      if (err != cudaSuccess) return err;
      const bool vec4 = (d % 4 == 0) && aligned16(x);
      search_expand_f32_kernel<F><<<(unsigned)q, 256, smem, stream>>>(
          x, n, d, queries, nbrs, r, table, h, valid, vwords, fwords, w, out_ids, out_dists,
          fresh, allowed, vec4, wquad);
      return cudaGetLastError();
    }
  }
  const bool quad = rows_quad<T>(x, d, scale, offset);
  const int lanes = quad ? lanes_per_row<T>(d, true, HASH_PROBES) : 32;
  if (scale != nullptr) {
    cudaError_t err = allow_smem(search_expand_kernel<T, true, F>, smem);
    if (err != cudaSuccess) return err;
    search_expand_kernel<T, true, F><<<(unsigned)q, 256, smem, stream>>>(
        x, scale, offset, n, d, queries, nbrs, r, table, h, valid, vwords, fwords, w, out_ids,
        out_dists, fresh, allowed, quad, lanes, wquad);
  } else {
    cudaError_t err = allow_smem(search_expand_kernel<T, false, F>, smem);
    if (err != cudaSuccess) return err;
    search_expand_kernel<T, false, F><<<(unsigned)q, 256, smem, stream>>>(
        x, scale, offset, n, d, queries, nbrs, r, table, h, valid, vwords, fwords, w, out_ids,
        out_dists, fresh, allowed, quad, lanes, wquad);
  }
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_rung(const void* x, const float* scale, const float* offset, int n,
                               int d, const float* queries, const int* nbrs, long long q, int r,
                               const int* table, int h, const uint8_t* valid, const int* vwords,
                               const int* fwords, int w, int* out_ids, float* out_dists,
                               uint8_t* fresh, uint8_t* allowed, cudaStream_t stream) {
  if (vwords != nullptr)
    return launch<T, true>(x, scale, offset, n, d, queries, nbrs, q, r, table, h, valid, vwords,
                           fwords, w, out_ids, out_dists, fresh, allowed, stream);
  return launch<T, false>(x, scale, offset, n, d, queries, nbrs, q, r, table, h, valid, vwords,
                          fwords, w, out_ids, out_dists, fresh, allowed, stream);
}

// vwords (N, W) / fwords (Q, W) int32 and `allowed` (Q, R) are all given
// (the filter variant) or all null.
extern "C" int search_expand_launch(const void* x, int dtype, const float* scale,
                                    const float* offset, int n, int d, const float* queries,
                                    const int* nbrs, long long q, int r, const int* table, int h,
                                    const uint8_t* valid, const int* vwords, const int* fwords,
                                    int w, int* out_ids, float* out_dists, uint8_t* fresh,
                                    uint8_t* allowed, cudaStream_t stream) {
  if (q == 0) return cudaSuccess;
  if ((vwords == nullptr) != (fwords == nullptr) || (vwords == nullptr) != (allowed == nullptr) ||
      (vwords != nullptr && w < 1))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case REPRO_F32:
      return launch_rung<float>(x, scale, offset, n, d, queries, nbrs, q, r, table, h, valid,
                                vwords, fwords, w, out_ids, out_dists, fresh, allowed, stream);
    case REPRO_BF16:
      return launch_rung<__nv_bfloat16>(x, scale, offset, n, d, queries, nbrs, q, r, table, h,
                                        valid, vwords, fwords, w, out_ids, out_dists, fresh,
                                        allowed, stream);
    case REPRO_I8:
      return launch_rung<int8_t>(x, scale, offset, n, d, queries, nbrs, q, r, table, h, valid,
                                 vwords, fwords, w, out_ids, out_dists, fresh, allowed, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
