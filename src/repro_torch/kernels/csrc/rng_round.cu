// One disordered GRNND propagation round (paper Alg. 4 lines 4-10).
//
// Replaces the TPU kernel src/repro/kernels/rng_round.py::rng_round_pallas
// (body _rng_round_kernel). Semantics: repro_torch/kernels/ref.py::rng_round_ref.
//
// Bound: bytes. Once per input, the round reads each distinct pool row once
// (0.57 ms at C = 10^6 fp32); but a vertex needs its own R rows, and the rows
// it gathers (R*D stored bytes a vertex, 24.6 GB a round at C = 10^6, R = 48,
// D = 128 fp32) are what the kernel moves, from device memory or from L2.
// The first port's kernel copied them a row per warp through registers after
// a dependent load of the row's id, so a block waited on about a dozen memory
// latencies per vertex with nothing to overlap. This design:
//   1. keeps every copy of a vertex in flight at once, off the computing
//      threads: warp 0 issues one TMA bulk copy (cp.async.bulk) per pool row
//      that a sampled pair touches (~87% of them at P = R = 48), as stored
//      bytes (fp32, bf16 or int8), and four for the vertex's ids / dists /
//      si / sj rows, each set completing on an mbarrier;
//   2. is persistent: a block of 4 warps walks vertices t, t + G, t + 2G, ...
//      (G blocks, as many as fit: 8 an SM at fp32, R = 48, D = 128). The
//      next vertex's index rows land while the current one computes; its
//      pool rows are waited for, and the SM's other blocks fill that wait.
//      On an H100 the round's rate follows the blocks an SM holds, not the
//      copies in flight, so a block keeps one row buffer: a second one (the
//      paper's double buffer) halves the blocks and was slower (PERF.md);
//   3. computes four sampled pairs a warp at once, a group of 8 lanes per
//      pair, with the summation and shuffle-reduction order of a warp per
//      pair (common.cuh::warp_row_sqdist), so dij is bitwise the first
//      port's; bf16 / int8 quads are dequantized on the read from shared
//      memory with the plain version's rounded multiply and add (no FMA);
//   4. stages a vertex's P results and R kill flags in shared memory and
//      drains them with consecutive threads after the next barrier.
// The round is then bound by each block's serial path per vertex (the
// copies' latency and its barriers), about the same whether the rows come
// from device memory or from L2: a vertex schedule that grouped vertices
// sharing pool rows, so that their rows stayed in L2, read no faster and
// was not kept (PERF.md). A stored row whose bytes are not a multiple of 16
// (or an unaligned base) is copied plainly by warp 0 in the same place of
// the pipeline.
//
// Direct reads: where a vertex's R stored rows do not fit in shared memory
// (R = 24 fp32 rows past D ~ 2,400: a kNN-LM datastore over a 3,584- or
// 4,096-wide model's states), the DIRECT instance stages no rows. The 8
// lanes of a pair's group read its two rows from device memory (through
// L2), quad for quad as the staged path reads them from shared memory, with
// the same summation and shuffle order, so dij is bitwise the staged
// path's. The index ring, the result stage and the kill flags stay in
// shared memory. No copy is overlapped with compute here: each group waits
// on its own loads.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BLOCKS_PER_SM = 8;  // at most 64 registers a thread

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
// the producer's one arrival of a phase, announcing `bytes` of copies
__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// one TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_copy(void* to, const void* from, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(to)),
      "l"(from), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// Byte offsets of the dynamic shared memory, the same on host and device
// (each under 227 KB, so an int).
struct Layout {
  int ring;   // 2 index slots of `rs` ints: ids (R), dists (R), si (P), sj (P)
  int rs;
  int stage;  // the results: dst (P), src (P), dij (P), kill (R) ints
  int scale;  // (D,) scale, then (D,) offset
  int bars;   // mbarriers: the row buffer's, then one per index slot
  size_t total;
};

__host__ __device__ inline Layout layout(int r, int p, int d, int tsize, bool q, bool direct) {
  Layout l;
  // the row buffer: R stored rows (none on the direct path)
  const size_t rbuf = direct ? 0 : align16((size_t)r * d * tsize);
  const int ss = (3 * p + r + 3) & ~3;
  l.rs = (2 * r + 2 * p + 3) & ~3;
  const size_t sc = q ? align16((size_t)2 * d * 4) : 0;
  l.total = rbuf + (size_t)(2 * l.rs + ss) * 4 + sc + 3 * 8;
  l.ring = (int)rbuf;
  l.stage = l.ring + 2 * l.rs * 4;
  l.scale = l.stage + ss * 4;
  l.bars = l.scale + (int)sc;
  return l;
}

// Quad c of a stored row, in shared memory or (direct path) device memory,
// dequantized with the shared scale / offset (bitwise
// common.cuh::dequant_quad). Without `vec` (a row base not aligned to a
// quad) the four elements are loaded one by one: the same values.
template <bool Q, typename T>
__device__ __forceinline__ float4 row_quad(const T* row, const float* sc, const float* of, int c,
                                           bool vec) {
  const T* e = row + 4 * c;
  float4 v = vec ? load_quad(e) : make_float4(widen(e[0]), widen(e[1]), widen(e[2]), widen(e[3]));
  if constexpr (Q) {
    const float4 s = reinterpret_cast<const float4*>(sc)[c];
    const float4 o = reinterpret_cast<const float4*>(of)[c];
    v = make_float4(affine(v.x, s.x, o.x), affine(v.y, s.y, o.y), affine(v.z, s.z, o.z),
                    affine(v.w, s.w, o.w));
  }
  return v;
}

// Squared distance of two stored rows over a group of 8
// lanes (`sub` = lane in group), bitwise common.cuh::warp_row_sqdist over a
// whole warp: lane sub holds that function's lanes sub, sub + 8, sub + 16
// and sub + 24 (each summing its quads, or elements, in the same order),
// adds them as its xor-16 and xor-8 shuffle steps would, and the group
// finishes with the xor-4, -2 and -1 steps.
template <bool Q, typename T>
__device__ __forceinline__ float group_sqdist(const T* a, const T* b, int d, const float* sc,
                                              const float* of, int sub, bool vec) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (d % 4 == 0) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
      for (int c = sub + 8 * m; c < d / 4; c += 32)
        acc[m] = quad_sqdist(row_quad<Q>(a, sc, of, c, vec), row_quad<Q>(b, sc, of, c, vec),
                             acc[m]);
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m)
      for (int k = sub + 8 * m; k < d; k += 32) {
        const float t = dequant<Q>(a[k], sc, of, k) - dequant<Q>(b[k], sc, of, k);
        acc[m] = fmaf(t, t, acc[m]);
      }
  }
  float v = (acc[0] + acc[2]) + (acc[1] + acc[3]);
  v += __shfl_xor_sync(REPRO_FULL_MASK, v, 4);
  v += __shfl_xor_sync(REPRO_FULL_MASK, v, 2);
  v += __shfl_xor_sync(REPRO_FULL_MASK, v, 1);
  return v;
}

// DIRECT: the rows are read from device memory (`bulk_rows` then says
// whether they can be read as quads), not staged.
template <typename T, bool Q, bool DIRECT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    rng_round_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ offset, int n, int d, const int* __restrict__ ids,
                     const float* __restrict__ dists, const int* __restrict__ si,
                     const int* __restrict__ sj, long long c, int r, int p, bool bulk_rows,
                     bool bulk_idx, int* __restrict__ dst, int* __restrict__ src,
                     float* __restrict__ dij, uint8_t* __restrict__ kill) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(r, p, d, (int)sizeof(T), Q, DIRECT);
  const int rb = d * (int)sizeof(T);
  unsigned char* rows_raw = smem;
  int* ring = reinterpret_cast<int*>(smem + L.ring);
  int* o_dst = reinterpret_cast<int*>(smem + L.stage);
  int* o_src = o_dst + p;
  float* o_dij = reinterpret_cast<float*>(o_src + p);
  int* kill_s = o_dst + 3 * p;
  float* s_scale = reinterpret_cast<float*>(smem + L.scale);
  float* s_off = s_scale + d;
  unsigned long long* row_bar = reinterpret_cast<unsigned long long*>(smem + L.bars);
  unsigned long long* idx_bar = row_bar + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 3, sub = lane & 7;
  const int cv = (int)c, G = gridDim.x;  // C < 2^31: vertex ids are int32
  auto slot = [&](int s) { return min(max(s, 0), r - 1); };
  auto row_id = [&](int id) { return (size_t)min(max(id, 0), n - 1); };

  auto vert = [&](long long t) -> int {
    return t < cv ? (int)t : -1;
  };
  // warp 0: the index rows of vertex v -> ring slot k, four bulk copies
  // (or, unaligned, plain copies that the next barrier publishes)
  auto issue_idx = [&](int k, int v) {
    int* to = ring + k * L.rs;
    const size_t at_r = (size_t)v * r, at_p = (size_t)v * p;
    if (bulk_idx) {
      if (lane == 0) {
        mbar_arrive_tx(&idx_bar[k], (2 * r + 2 * p) * 4);
        bulk_copy(to, ids + at_r, r * 4, &idx_bar[k]);
        bulk_copy(to + r, dists + at_r, r * 4, &idx_bar[k]);
        bulk_copy(to + 2 * r, si + at_p, p * 4, &idx_bar[k]);
        bulk_copy(to + 2 * r + p, sj + at_p, p * 4, &idx_bar[k]);
      }
    } else {
      for (int w = lane; w < 2 * r + 2 * p; w += 32)
        to[w] = w < r           ? ids[at_r + w]
                : w < 2 * r     ? __float_as_int(dists[at_r + w - r])
                : w < 2 * r + p ? si[at_p + w - 2 * r]
                                : sj[at_p + w - 2 * r - p];
      __syncwarp();
      if (lane == 0) mbar_arrive_tx(&idx_bar[k], 0);
    }
  };
  // warp 0: the pool rows of ring slot k that a sampled pair touches -> the
  // row buffer, one bulk copy a row, 32 slots a word of the touched mask
  // (or, unaligned, plain copies of every row that the next barrier
  // publishes)
  auto issue_rows = [&](int k) {
    const int* s_ids = ring + k * L.rs;
    const int* s_si = s_ids + 2 * r;
    const int* s_sj = s_si + p;
    if (!bulk_rows) {
      T* rows = reinterpret_cast<T*>(rows_raw);
      for (int u = lane; u < r * d; u += 32)
        rows[u] = x[row_id(s_ids[u / d]) * d + u % d];
    } else {
      for (int s0 = 0; s0 < r; s0 += 32) {
        unsigned bits = 0;
        for (int q = lane; q < p; q += 32) {
          const unsigned a = slot(s_si[q]) - s0, bq = slot(s_sj[q]) - s0;
          bits |= (a < 32 ? 1u << a : 0u) | (bq < 32 ? 1u << bq : 0u);
        }
        bits = __reduce_or_sync(REPRO_FULL_MASK, bits);
        if (lane == 0) mbar_expect_tx(row_bar, __popc(bits) * rb);
        __syncwarp();
        if ((bits >> lane) & 1u) {
          const int s = s0 + lane;
          const size_t id = row_id(s_ids[s]);
          bulk_copy(rows_raw + (size_t)s * rb, reinterpret_cast<const unsigned char*>(x) + id * rb,
                    rb, row_bar);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive_tx(row_bar, 0);
  };
  // the sampled pairs of ring slot k over the row buffer (or, DIRECT, over
  // the rows in device memory) -> the result stage: a group of 8 lanes per
  // pair, four pairs a warp at once
  auto compute = [&](int k) {
    const int* s_ids = ring + k * L.rs;
    const float* s_dists = reinterpret_cast<const float*>(s_ids + r);
    const int* s_si = s_ids + 2 * r;
    const int* s_sj = s_si + p;
    const T* rows = reinterpret_cast<const T*>(rows_raw);
    for (int base = 4 * warp; base < p; base += THREADS / 8) {
      const int q = base + grp;
      const bool ok = q < p;
      const int a = ok ? slot(s_si[q]) : 0, bq = ok ? slot(s_sj[q]) : 0;
      float dd;
      if constexpr (DIRECT)
        dd = group_sqdist<Q>(x + row_id(s_ids[a]) * d, x + row_id(s_ids[bq]) * d, d, s_scale,
                             s_off, sub, bulk_rows);
      else
        dd = group_sqdist<Q>(rows + (size_t)a * d, rows + (size_t)bq * d, d, s_scale, s_off, sub,
                             true);
      if (ok && sub == 0) {
        const int ni = s_ids[a], nj = s_ids[bq];
        const float dvi = s_dists[a], dvj = s_dists[bq];
        const bool valid = ni >= 0 && nj >= 0 && ni != nj;
        const bool hit = valid && dd < fmaxf(dvi, dvj);
        const bool i_far = dvi > dvj;
        o_dst[q] = hit ? (i_far ? nj : ni) : -1;
        o_src[q] = i_far ? ni : nj;
        o_dij[q] = dd;
        if (hit) kill_s[i_far ? a : bq] = 1;
      }
    }
  };
  // the result stage of vertex v -> the outputs, by consecutive threads
  auto drain = [&](int v) {
    const size_t at_p = (size_t)v * p, at_r = (size_t)v * r;
    for (int q = tid; q < p; q += THREADS) {
      dst[at_p + q] = o_dst[q];
      src[at_p + q] = o_src[q];
      dij[at_p + q] = o_dij[q];
    }
    for (int s = tid; s < r; s += THREADS) {
      kill[at_r + s] = (uint8_t)kill_s[s];
      kill_s[s] = 0;
    }
  };

  const int t0 = blockIdx.x;
  if (t0 >= cv) return;
  if constexpr (Q) {
    for (int k = tid; k < d; k += THREADS) {
      s_scale[k] = scale[k];
      s_off[k] = offset[k];
    }
  }
  for (int s = tid; s < r; s += THREADS) kill_s[s] = 0;
  if (tid < 3) mbar_init(&row_bar[tid]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // step i (vertex t0 + i * G) uses index slot i % 2; a barrier's phase
  // parity is the count of its earlier uses, mod 2. Wait for the step's
  // index rows, drain step i - 1, let warp 0 issue the step's row copies and
  // the next step's index copies, wait for the rows, compute. Vertex ids are
  // read a step before they are needed.
  int prev = -1, cur = vert(t0), next = vert((long long)t0 + G), i = 0;
  if (warp == 0) issue_idx(0, cur);
  for (int t = t0; t < cv; t += G, ++i) {
    mbar_wait(&idx_bar[i & 1], (i >> 1) & 1);
    __syncthreads();  // the row buffer and the index slot of step i + 1 are free
    if (prev >= 0) drain(prev);
    if (warp == 0) {
      if constexpr (!DIRECT) issue_rows(i & 1);
      if (next >= 0) issue_idx((i + 1) & 1, next);
    }
    const int after = vert((long long)t + 2 * G);
    if constexpr (!DIRECT) mbar_wait(row_bar, i & 1);
    __syncthreads();  // plain copies published, the stage drained
    compute(i & 1);
    prev = cur;
    cur = next;
    next = after;
  }
  __syncthreads();
  drain(prev);
}

template <typename T, bool Q, bool DIRECT>
cudaError_t launch_q(const T* x, const float* scale, const float* offset, int n, int d,
                     const int* ids, const float* dists, const int* si, const int* sj,
                     long long c, int r, int p, int* dst, int* src, float* dij, uint8_t* kill,
                     cudaStream_t stream) {
  auto kernel = rng_round_kernel<T, Q, DIRECT>;
  const size_t smem = layout(r, p, d, (int)sizeof(T), Q, DIRECT).total;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fit = (long long)sms * per_sm, grid = c < fit ? c : fit;
  // staged: rows by bulk copies; direct: rows read as quads
  const bool bulk_rows = DIRECT ? aligned_to(x, 4 * sizeof(T))
                                : (d * sizeof(T)) % 16 == 0 && aligned_to(x, 16);
  const bool bulk_idx = r % 4 == 0 && p % 4 == 0 && aligned_to(ids, 16) &&
                        aligned_to(dists, 16) && aligned_to(si, 16) && aligned_to(sj, 16);
  kernel<<<(unsigned)grid, THREADS, smem, stream>>>(x, scale, offset, n, d, ids, dists, si, sj,
                                                    c, r, p, bulk_rows, bulk_idx, dst, src, dij,
                                                    kill);
  return cudaGetLastError();
}

template <typename T, bool DIRECT>
cudaError_t launch_d(const T* x, const float* scale, const float* offset, int n, int d,
                     const int* ids, const float* dists, const int* si, const int* sj,
                     long long c, int r, int p, int* dst, int* src, float* dij, uint8_t* kill,
                     cudaStream_t stream) {
  if (scale != nullptr)
    return launch_q<T, true, DIRECT>(x, scale, offset, n, d, ids, dists, si, sj, c, r, p, dst,
                                     src, dij, kill, stream);
  return launch_q<T, false, DIRECT>(x, scale, offset, n, d, ids, dists, si, sj, c, r, p, dst, src,
                                    dij, kill, stream);
}

template <typename T>
cudaError_t launch(const void* xv, const float* scale, const float* offset, int n, int d,
                   const int* ids, const float* dists, const int* si, const int* sj,
                   long long c, int r, int p, int* dst, int* src, float* dij, uint8_t* kill,
                   bool direct, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  if (direct)
    return launch_d<T, true>(x, scale, offset, n, d, ids, dists, si, sj, c, r, p, dst, src, dij,
                             kill, stream);
  return launch_d<T, false>(x, scale, offset, n, d, ids, dists, si, sj, c, r, p, dst, src, dij,
                            kill, stream);
}

}  // namespace

// Shared-memory bytes the kernel takes, staged or direct (the wrapper picks
// the path by them).
extern "C" long long rng_round_smem_bytes(int r, int p, int d, int tsize, int q, int direct) {
  return (long long)layout(r, p, d, tsize, q != 0, direct != 0).total;
}

extern "C" int rng_round_launch(const void* x, int dtype, const float* scale, const float* offset,
                                int n, int d, const int* ids, const float* dists, const int* si,
                                const int* sj, long long c, int r, int p, int* dst, int* src,
                                float* dij, uint8_t* kill, int direct, cudaStream_t stream) {
  if (c == 0) return cudaSuccess;
  switch (dtype) {
    case REPRO_F32:
      return launch<float>(x, scale, offset, n, d, ids, dists, si, sj, c, r, p, dst, src, dij,
                           kill, direct != 0, stream);
    case REPRO_BF16:
      return launch<__nv_bfloat16>(x, scale, offset, n, d, ids, dists, si, sj, c, r, p, dst, src,
                                   dij, kill, direct != 0, stream);
    case REPRO_I8:
      return launch<int8_t>(x, scale, offset, n, d, ids, dists, si, sj, c, r, p, dst, src, dij,
                            kill, direct != 0, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
