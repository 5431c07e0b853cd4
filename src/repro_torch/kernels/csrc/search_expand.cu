// One beam-search expansion step: neighbor gather + query distances + visited
// probe, with the optional tombstone mask and label predicate.
//
// Replaces the TPU kernel src/repro/kernels/search_expand.py::search_expand_pallas
// (body _search_expand_kernel) in its storage variants (fp32, bf16, int8
// with the per-dimension scale/offset dequant), its `valid` variant and its
// filter variant. Semantics: repro_torch/kernels/ref.py::search_expand_ref.
//
// Bound: the unique stored neighbor rows a step reads (plus their label
// words with the filter), the Q*R ids, the probed table slots and the
// outputs. Each neighbor is a chain of dependent loads (id, then valid byte
// / table window / label words, then the row), so the design puts each
// query's loads of one kind in flight together instead of one neighbor
// after another, and overlaps one query's rows with the next one's ids.
// Persistent blocks of 256 threads (as many as the SMs hold, 8 an SM at
// fp32, R = 48, D = 128) take queries q, q + G, ...; for each:
//   1. (done while the previous query was in step 2) thread j read
//      neighbor j's id and, with the mask, its valid byte, and wrote the
//      output id and the live row index into shared memory, beside the
//      query row. A neighbor is live when its id is >= 0 and, with the
//      mask, its valid byte is set; a dead one comes out exactly as an
//      empty slot (id -1, +inf, not fresh, not allowed) and reads no row,
//      probe or label word.
//   2. a group of L lanes per neighbor (a warp for fp32 rows without a
//      dequant; one lane per 16 B of stored row, 8 to 32, on the quantized
//      rungs) takes neighbors g, g + G', .... When the stored rows are a
//      multiple of 16 B, 16-byte aligned, and the block's R rows fit 32 KB
//      (fp32 to R = 64 at D = 128), the groups first issue 16-byte
//      cp.async copies of all live rows into shared memory, so the rows are
//      in flight together with no register held for them. While they fly,
//      thread j reads live neighbor j's 8 table slots (max(v,0) % H + l) % H
//      and (with the filter, a compile-time flag F) its W label words ANDed
//      with the query's predicate words (int4 loads when W % 4 == 0 and the
//      words are 16-byte aligned), writes fresh and allowed (consecutive
//      threads, consecutive slots), and does step 1 for the block's next
//      query into the other buffer. The groups then wait once; rows that
//      cannot be copied so are read from device memory one neighbor at a
//      time. Either way each row is dequantized (bitwise the plain
//      version's rows) and summed in the per-lane order and shuffle tree of
//      the kernels this one replaced (a warp's float4 tree for fp32), so
//      dists are bitwise theirs; lane 0 of a group writes the distance to
//      shared memory. Route-through: the filter changes neither ids, dists
//      nor fresh.
//   3. after a barrier, consecutive threads write the distances.
// 27 KB of shared memory a block at fp32, R = 48, D = 128.
#include <algorithm>

#include "common.cuh"

#define HASH_PROBES 8

// Whether any of the W label words `vw` of one neighbor intersects the
// query's predicate words `fw` (int4 loads with quad).
__device__ __forceinline__ bool label_hit(const int* __restrict__ vw,
                                          const int* __restrict__ fw, int w, bool quad) {
  bool hit = false;
  if (quad) {
    const int4* v4 = reinterpret_cast<const int4*>(vw);
    const int4* f4 = reinterpret_cast<const int4*>(fw);
    for (int c = 0; c < w / 4; ++c) {
      const int4 a = __ldg(v4 + c), b = __ldg(f4 + c);
      hit |= ((a.x & b.x) | (a.y & b.y) | (a.z & b.z) | (a.w & b.w)) != 0;
    }
  } else {
    for (int k = 0; k < w; ++k) hit |= (__ldg(vw + k) & __ldg(fw + k)) != 0;
  }
  return hit;
}

// Whether the live rows go through shared memory by 16-byte async copies
// (stored rows of a multiple of 16 bytes, 16-byte aligned, and R rows that
// fit the budget below), else straight from device memory, a row at a time.
constexpr size_t ROWS_SMEM_MAX = 32 * 1024;

// Shared-memory bytes before the rows: two query rows, two (ids, live)
// pairs of R ints, R dists, rounded to 16.
__host__ __device__ inline size_t head_bytes(int d, int r) {
  return ((2 * (size_t)((d + 3) & ~3) + 5 * (size_t)r) * 4 + 15) / 16 * 16;
}

// Resident blocks asked of the compiler per SM: 8 (32 registers a thread),
// but 6 for fp32 rows with the filter, which spills at 32 registers and
// read slower so.
template <typename T, bool F>
struct MinBlocks {
  static constexpr int value = F && sizeof(T) == 4 ? 6 : 8;
};

template <typename T, bool Q, bool F, bool ASYNC>
__global__ void __launch_bounds__(256, MinBlocks<T, F>::value)
    search_expand_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                         const float* __restrict__ offset, int n, int d,
                         const float* __restrict__ queries, const int* __restrict__ nbrs,
                         long long nq, int r, const int* __restrict__ table, int h,
                         const uint8_t* __restrict__ valid, const int* __restrict__ vwords,
                         const int* __restrict__ fwords, int w, int* __restrict__ out_ids,
                         float* __restrict__ out_dists, uint8_t* __restrict__ fresh,
                         uint8_t* __restrict__ allowed, bool quad, int lanes, bool wquad) {
  // two buffers (this query's, the next one's) of the query row (dp,), the
  // ids (R,) and the live rows (R,); the dists (R,); with ASYNC the R
  // stored rows
  extern __shared__ __align__(16) float smf[];
  const int dp = (d + 3) & ~3;
  int* ids = reinterpret_cast<int*>(smf + 2 * dp);
  int* live = ids + 2 * r;
  float* dist = reinterpret_cast<float*>(live + 2 * r);
  char* rows = reinterpret_cast<char*>(smf) + head_bytes(d, r);
  const int tid = threadIdx.x;
  const int lane = tid & 31, sub = lane & (lanes - 1);
  const int group = tid / lanes, ngroups = blockDim.x / lanes;
  const int rb = d * (int)sizeof(T);  // stored row bytes

  // query qq's row, and slot j's valid byte, live row and output id, into
  // buffer bb
  auto stage_row = [&](long long qq, int bb) {
    for (int k = tid; k < d; k += blockDim.x) smf[bb * dp + k] = queries[qq * d + k];
  };
  auto settle = [&](long long qq, int bb, int j, int v) {
    const int vc = min(max(v, 0), n - 1);
    bool alive = v >= 0;
    if (alive && valid != nullptr) alive = valid[vc] != 0;
    ids[bb * r + j] = v;
    live[bb * r + j] = alive ? vc : -1;
    out_ids[qq * r + j] = alive ? v : -1;
  };

  long long q = blockIdx.x;
  stage_row(q, 0);
  for (int j = tid; j < r; j += blockDim.x) settle(q, 0, j, nbrs[q * r + j]);
  __syncthreads();

  for (int b = 0; q < nq; q += gridDim.x, b ^= 1) {
    const int* lv = live + b * r;
    // 1. the live rows' copies (a group of `lanes` lanes per neighbor)
    if constexpr (ASYNC) {
      for (int j = group; j < r; j += ngroups) {
        const int v = lv[j];
        if (v < 0) continue;
        const char* src = reinterpret_cast<const char*>(x) + (int64_t)v * rb;
        for (int c = 16 * sub; c < rb; c += 16 * lanes)
          cp_async16(rows + (size_t)j * rb + c, src + c, 16);
      }
      cp_async_commit();
    }
    // 2. while they fly: the next query's row and ids, and this one's
    // probes and label words
    const long long qn = q + gridDim.x;
    const bool next = qn < nq;
    if (next) stage_row(qn, b ^ 1);
    const int* tab = table + q * h;
    for (int j = tid; j < r; j += blockDim.x) {
      const int vn = next ? nbrs[qn * r + j] : -1;
      const int64_t o = q * r + j;
      const int v = ids[b * r + j];
      const bool alive = lv[j] >= 0;
      bool found = false, hit = false;
      if (alive) {
        const int p0 = v % h;
#pragma unroll
        for (int l = 0; l < HASH_PROBES; ++l) {
          int p = p0 + l;
          if (p >= h) p %= h;
          found |= tab[p] == v;
        }
        if constexpr (F) hit = label_hit(vwords + (int64_t)lv[j] * w, fwords + q * w, w, wquad);
      }
      fresh[o] = (uint8_t)(alive && !found);
      if constexpr (F) allowed[o] = (uint8_t)(alive && hit);
      if (next) settle(qn, b ^ 1, j, vn);
    }
    if constexpr (ASYNC) {
      cp_async_wait<0>();
      __syncwarp();  // a group's lanes sit in one warp
    }
    // 3. the distances; a uniform trip count: every lane reaches every shuffle
    for (int base = 0; base < r; base += ngroups) {
      const int j = base + group;
      const int v = j < r ? lv[j] : -1;
      float part = 0.f;
      if (v >= 0) {
        const T* row =
            ASYNC ? reinterpret_cast<const T*>(rows + (size_t)j * rb) : x + (int64_t)v * d;
        part = part_sqdist_query<Q>(smf + b * dp, row, d, scale, offset, quad, sub, lanes);
      }
      const float dd = group_sum(part, lanes);
      if (sub == 0 && v >= 0) dist[j] = dd;
    }
    __syncthreads();
    for (int j = tid; j < r; j += blockDim.x)
      out_dists[q * r + j] = lv[j] >= 0 ? dist[j] : CUDART_INF_F;
    __syncthreads();  // the rows, the dists and this buffer are free again
  }
}

// One launch of the instantiation that fits: Q (a dequant) and F (the
// filter) are compile-time flags, so the filter-free fp32 code carries
// neither. The blocks are persistent: as many as the SMs hold at once.
template <typename T, bool Q, bool F>
static cudaError_t launch(const T* x, const float* scale, const float* offset, int n, int d,
                          const float* queries, const int* nbrs, long long q, int r,
                          const int* table, int h, const uint8_t* valid, const int* vwords,
                          const int* fwords, int w, int* out_ids, float* out_dists,
                          uint8_t* fresh, uint8_t* allowed, cudaStream_t stream) {
  const bool quad = rows_quad<T>(x, d, scale, offset);
  const int lanes = (sizeof(T) == 4 && !Q) ? 32 : (quad ? lanes_per_row<T>(d, true, HASH_PROBES) : 32);
  const bool wquad = F && w % 4 == 0 && aligned16(vwords) && aligned16(fwords);
  const size_t row_bytes = (size_t)d * sizeof(T) * r;
  const bool async = quad && (d * sizeof(T)) % 16 == 0 && aligned16(x) && row_bytes <= ROWS_SMEM_MAX;
  const size_t smem = head_bytes(d, r) + (async ? row_bytes : 0);
#define REPRO_EXPAND(AA)                                                                         \
  {                                                                                              \
    auto kernel = search_expand_kernel<T, Q, F, AA>;                                             \
    cudaError_t err = allow_smem(kernel, smem);                                                  \
    if (err != cudaSuccess) return err;                                                          \
    int per_sm = 0;                                                                              \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256, smem);             \
    if (err != cudaSuccess) return err;                                                          \
    const long long blocks = std::min<long long>(q, (long long)std::max(per_sm, 1) * sm_count()); \
    kernel<<<(unsigned)blocks, 256, smem, stream>>>(x, scale, offset, n, d, queries, nbrs, q, r,  \
                                                   table, h, valid, vwords, fwords, w, out_ids,  \
                                                   out_dists, fresh, allowed, quad, lanes, wquad); \
    return cudaGetLastError();                                                                   \
  }
  if (async) REPRO_EXPAND(true)
  REPRO_EXPAND(false)
#undef REPRO_EXPAND
}

template <typename T>
static cudaError_t launch_rung(const void* xv, const float* scale, const float* offset, int n,
                               int d, const float* queries, const int* nbrs, long long q, int r,
                               const int* table, int h, const uint8_t* valid, const int* vwords,
                               const int* fwords, int w, int* out_ids, float* out_dists,
                               uint8_t* fresh, uint8_t* allowed, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
#define REPRO_RUNG(QQ, FF)                                                                      \
  return launch<T, QQ, FF>(x, scale, offset, n, d, queries, nbrs, q, r, table, h, valid, vwords, \
                           fwords, w, out_ids, out_dists, fresh, allowed, stream)
  if (scale != nullptr) {
    if (vwords != nullptr) REPRO_RUNG(true, true);
    REPRO_RUNG(true, false);
  }
  if (vwords != nullptr) REPRO_RUNG(false, true);
  REPRO_RUNG(false, false);
#undef REPRO_RUNG
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
