// Paired squared distances over gathered rows: out[m] = |x[ni[m]] - x[nj[m]]|^2.
//
// Replaces the TPU kernel src/repro/kernels/gather_l2.py::gather_sqdist_pallas
// (body _gather_l2_kernel). Semantics: repro_torch/kernels/ref.py::gather_sqdist_ref.
//
// Its main caller is the dynamic index's re-base: M = 43.2M pairs (ni, nj)
// = (owner, pool neighbor) over a (2^20, 128) int8 or bf16 tier, `ni` in
// runs of R = 48 equal ids. The PR 12 kernel kept one pair in flight a lane
// group, re-read the scale / offset four float4s a quad a pair (~88 GB from
// L1), widened int8 by I2F and reloaded the owner row every pair: 4.207 /
// 5.578 ms at int8 / bf16 (H100 80GB HBM3, 700 W).
//
// Design (kernel gather_sqdist_runs):
//   * a lane group of L lanes per row (one lane per 16 B of stored row, 8
//     to 32) keeps the dims-to-lane split and xor-shuffle tree of the PR 12
//     kernel (lane `sub` sums quads sub, sub + L, ... in order), so `out`
//     is bitwise that kernel's;
//   * persistent blocks; each group walks a contiguous range of pairs, P = 4
//     a batch: the next batch's ni / nj load while this batch's rows fly,
//     and the P neighbor rows are all loaded before any is widened;
//   * the owner row is dequantized once a run of equal ni (clamped) into
//     shared memory, each lane reading back only its own quads; a change
//     reloads it, so any ni order stays right. The scale / offset sit in
//     shared memory too, read once a batch: with both out of registers the
//     kernel runs at 64 registers, 32 warps an SM (3.67 -> 3.03 ms at int8);
//   * the groups of a warp step together: a warp-uniform trip count, one
//     choice of the in-run path for the whole warp, whole-warp shuffles.
//     Groups left to branch apart issued one at a time (4.67 against 3.67
//     ms at int8, 4 groups a warp);
//   * int8 widens by byte permutes: (float)c of a signed byte c equals
//     __int_as_float(0x4B000000 | (c ^ 0x80)) - 8388736, exactly, on the
//     integer and FMA pipes instead of I2F;
//   * lane u < P of a group stores pair u of the batch: consecutive lanes,
//     consecutive out[m].
// What bounds it now (M = 43.2M, times as above): bf16 2.99 ms, under the
// 3.53 ms its gathered rows take from device memory (L2 serves some): bytes.
// int8 3.03 ms against 1.84 ms of rows and ~1.3 ms of issue (~6
// instructions an element): the latency between a batch's loads and its
// sums, at 4-byte row loads (four L1 misses a row). 16-byte loads dealt out
// through shared memory, a software pipeline of batches, 8 pairs a batch
// and a cp.async ring of rows in shared memory read no faster.
// Rows with D % 4 != 0 (D = 33) or unaligned rows take gather_sqdist_pairs,
// the PR 12 kernel, one pair a group, element by element. Its quad branch
// is kept only for rows of over 8 quads a lane (D > 1024 at 32 lanes),
// which no preset or path runs; the card test at D = 1040 covers it.
// Indices are clamped to [0, N-1] in the kernels; row offsets are int64.
#include <algorithm>

#include "common.cuh"

constexpr int THREADS = 128;
// Resident blocks an SM asked of the compiler: 8 (64 registers a thread,
// 32 warps); fewer registers spill.
constexpr int MIN_BLOCKS = 8;

// ---------------------------------------------------------------------------
// The general kernel: one pair a lane group (a warp without quads).
// ---------------------------------------------------------------------------
template <typename T, bool Q>
__global__ void __launch_bounds__(256)
gather_sqdist_pairs(const T* __restrict__ x, long long n, int d, const int* __restrict__ ni,
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

// ---------------------------------------------------------------------------
// The run-aware kernel.
// ---------------------------------------------------------------------------

// One stored quad as loaded: 4, 2 or 1 32-bit words for fp32, bf16, int8.
template <typename T>
struct Words {
  uint32_t w[sizeof(T)];
};

// A quad's load as volatile PTX (non-coherent path): the compiler keeps the
// batch's loads where they are written, ahead of every widen.
__device__ __forceinline__ void load_words(Words<float>& r, const float* p) {
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3])
               : "l"(p));
}
__device__ __forceinline__ void load_words(Words<__nv_bfloat16>& r, const __nv_bfloat16* p) {
  asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n" : "=r"(r.w[0]), "=r"(r.w[1]) : "l"(p));
}
__device__ __forceinline__ void load_words(Words<int8_t>& r, const int8_t* p) {
  asm volatile("ld.global.nc.u32 %0, [%1];\n" : "=r"(r.w[0]) : "l"(p));
}


// A signed byte of `u` (already XORed with 0x80808080), placed by a byte
// permute under the exponent of 2^23: exactly (float)c, without I2F.
template <int K>
__device__ __forceinline__ float byte_to_float(uint32_t u) {
  return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | K)), 8388736.0f);
}

// A quad widened to fp32, bitwise load_quad (common.cuh).
__device__ __forceinline__ float4 widen_words(const Words<float>& r) {
  return make_float4(__uint_as_float(r.w[0]), __uint_as_float(r.w[1]), __uint_as_float(r.w[2]),
                     __uint_as_float(r.w[3]));
}
__device__ __forceinline__ float4 widen_words(const Words<__nv_bfloat16>& r) {
  return make_float4(__uint_as_float(r.w[0] << 16), __uint_as_float(r.w[0] & 0xffff0000u),
                     __uint_as_float(r.w[1] << 16), __uint_as_float(r.w[1] & 0xffff0000u));
}
__device__ __forceinline__ float4 widen_words(const Words<int8_t>& r) {
  const uint32_t u = r.w[0] ^ 0x80808080u;
  return make_float4(byte_to_float<0>(u), byte_to_float<1>(u), byte_to_float<2>(u),
                     byte_to_float<3>(u));
}

// A quad widened and dequantized, bitwise common.cuh::dequant_quad.
template <bool Q, typename T>
__device__ __forceinline__ float4 dequant_words(const Words<T>& r, float4 s, float4 o) {
  float4 v = widen_words(r);
  if constexpr (Q)
    v = make_float4(affine(v.x, s.x, o.x), affine(v.y, s.y, o.y), affine(v.z, s.z, o.z),
                    affine(v.w, s.w, o.w));
  return v;
}

// Pairs a batch: 16 words of neighbor row a lane (4 pairs at the 16 bytes a
// lane a row of the main path), 1 to 4.
template <typename T, int QPL>
__host__ __device__ constexpr int pairs_in_flight() {
  constexpr int p = 16 / (QPL * (int)sizeof(T));
  return p > 4 ? 4 : (p < 1 ? 1 : p);
}

// Dynamic shared memory of a block: the scale / offset quads (with a
// dequant), then a dequantized owner row a group.
template <bool Q>
__host__ __device__ inline int runs_smem(int d, int lanes) {
  return (Q ? 2 * d * 4 : 0) + THREADS / lanes * d * 4;
}

// QPL: quads a lane (ceil(D / 4 / L), rounded up to a power of two).
template <typename T, bool Q, int QPL>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gather_sqdist_runs(const T* __restrict__ x, long long n, int d, const int* __restrict__ ni,
                   const int* __restrict__ nj, long long m, long long chunk,
                   const float* __restrict__ scale, const float* __restrict__ offset,
                   float* __restrict__ out, int lanes) {
  constexpr int P = pairs_in_flight<T, QPL>();
  extern __shared__ __align__(16) float4 smq[];
  const int sub = (threadIdx.x & 31) & (lanes - 1);
  const long long lo = ((long long)blockIdx.x * THREADS + threadIdx.x) / lanes * chunk;
  const long long hi = min(lo + chunk, m);  // lo >= hi: a group with nothing to do
  const int nq = d / 4;

  // shared memory (registers are what bound the resident warps): the
  // scale / offset quads, then each group's owner row, dequantized, its
  // lanes each reading back only the quads they wrote
  float4* const so = smq;
  float4* const own = smq + (Q ? 2 * nq : 0) + threadIdx.x / lanes * nq;
  if constexpr (Q) {
    for (int c = threadIdx.x; c < nq; c += THREADS) {
      so[c] = __ldg(reinterpret_cast<const float4*>(scale) + c);
      so[nq + c] = __ldg(reinterpret_cast<const float4*>(offset) + c);
    }
    __syncthreads();
  }
  auto sc = [&](int c) { return Q ? so[c] : float4(); };
  auto of = [&](int c) { return Q ? so[nq + c] : float4(); };
  int cur = -1;  // the owner row's id

  // lane u < P holds pair m0 + u's clamped ids; -1 past the range
  auto load_ids = [&](long long m0, int& a, int& b) {
    a = -1;
    b = 0;
    const long long mm = m0 + sub;
    if (sub < P && mm < hi) {
      a = (int)min(max((long long)__ldg(ni + mm), 0ll), n - 1);
      b = (int)min(max((long long)__ldg(nj + mm), 0ll), n - 1);
    }
  };

  int ia, ib;
  load_ids(lo, ia, ib);
  // the warp's most batches of a group
  const unsigned batches = __reduce_max_sync(
      REPRO_FULL_MASK, hi > lo ? (unsigned)((hi - lo + P - 1) / P) : 0u);
  for (unsigned t = 0; t < batches; ++t) {
    const long long m0 = lo + (long long)t * P;
    int na, nb;
    load_ids(m0 + P, na, nb);  // the next batch's ids, under this batch's rows
    // the batch's owner / neighbor ids (broadcast from lanes u < P), and
    // every neighbor row of the batch, loaded before any is widened
    int a[P], b[P];
#pragma unroll
    for (int u = 0; u < P; ++u) {
      a[u] = __shfl_sync(REPRO_FULL_MASK, ia, u, lanes);
      b[u] = __shfl_sync(REPRO_FULL_MASK, ib, u, lanes);
    }
    Words<T> wb[P][QPL];
#pragma unroll
    for (int u = 0; u < P; ++u) {
      if (a[u] < 0) continue;
      const T* rb = x + (int64_t)b[u] * d;
#pragma unroll
      for (int i = 0; i < QPL; ++i) {
        const int c = sub + i * lanes;
        if (c < nq) load_words(wb[u][i], rb + 4 * c);
      }
    }
    ia = na;
    ib = nb;
    bool same = true;  // every pair of the batch is live and has owner `cur`
#pragma unroll
    for (int u = 0; u < P; ++u) same = same && a[u] == cur;
    float acc[P];
#pragma unroll
    for (int u = 0; u < P; ++u) acc[u] = 0.f;
    if (__all_sync(REPRO_FULL_MASK, same)) {
      // inside a run in every group: the P pairs' sums side by side, each
      // in its own quad order
#pragma unroll
      for (int i = 0; i < QPL; ++i) {
        const int c = sub + i * lanes;
        if (c < nq) {
          const float4 si = sc(c), oi = of(c), wi = own[c];
#pragma unroll
          for (int u = 0; u < P; ++u)
            acc[u] = quad_sqdist(wi, dequant_words<Q>(wb[u][i], si, oi), acc[u]);
        }
      }
    } else {
      // a change of owner, or a range's tail, in some group: pair by pair
#pragma unroll
      for (int u = 0; u < P; ++u) {
        if (a[u] < 0) continue;
        if (a[u] != cur) {  // the new owner's row (its loads wait here)
          const T* ra = x + (int64_t)a[u] * d;
#pragma unroll
          for (int i = 0; i < QPL; ++i) {
            const int c = sub + i * lanes;
            if (c < nq) {
              Words<T> w;
              load_words(w, ra + 4 * c);
              own[c] = dequant_words<Q>(w, sc(c), of(c));
            }
          }
          cur = a[u];
        }
#pragma unroll
        for (int i = 0; i < QPL; ++i) {
          const int c = sub + i * lanes;
          if (c < nq)
            acc[u] = quad_sqdist(own[c], dequant_words<Q>(wb[u][i], sc(c), of(c)), acc[u]);
        }
      }
    }
    float res = 0.f;
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const float v = group_sum(acc[u], lanes);
      if (sub == u) res = v;
    }
    if (sub < P && m0 + sub < hi) out[m0 + sub] = res;
  }
}

template <typename T, bool Q, int QPL>
static cudaError_t launch_runs(const T* x, long long n, int d, const int* ni, const int* nj,
                               long long m, const float* scale, const float* offset, float* out,
                               int lanes, cudaStream_t stream) {
  constexpr int P = pairs_in_flight<T, QPL>();
  auto kernel = gather_sqdist_runs<T, Q, QPL>;
  const int smem = runs_smem<Q>(d, lanes);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  const int per_block = THREADS / lanes;
  const long long batches = (m + P - 1) / P;
  const long long blocks = std::min<long long>((long long)std::max(per_sm, 1) * sm_count(),
                                               (batches + per_block - 1) / per_block);
  const long long groups = blocks * per_block;
  const long long chunk = ((m + groups - 1) / groups + P - 1) / P * P;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(x, n, d, ni, nj, m, chunk, scale, offset,
                                                      out, lanes);
  return cudaGetLastError();
}

template <typename T, bool Q>
static cudaError_t launch_q(const T* x, long long n, int d, const int* ni, const int* nj,
                            long long m, const float* scale, const float* offset, float* out,
                            cudaStream_t stream) {
  const bool quad = rows_quad<T>(x, d, scale, offset);
  const int lanes = quad ? lanes_per_row<T>(d, true, 8) : 32;
  const int qpl = quad ? (d / 4 + lanes - 1) / lanes : 0;
#define REPRO_RUNS(QPL) \
  return launch_runs<T, Q, QPL>(x, n, d, ni, nj, m, scale, offset, out, lanes, stream)
  if (quad && qpl <= 1) REPRO_RUNS(1);
  if (quad && qpl <= 2) REPRO_RUNS(2);
  if (quad && qpl <= 4) REPRO_RUNS(4);
  if (quad && qpl <= 8) REPRO_RUNS(8);
#undef REPRO_RUNS
  const long long blocks = (m * lanes + 255) / 256;
  gather_sqdist_pairs<T, Q><<<(unsigned)blocks, 256, 0, stream>>>(x, n, d, ni, nj, m, scale, offset,
                                                                  out, quad, lanes);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch(const void* xv, long long n, int d, const int* ni, const int* nj,
                          long long m, const float* scale, const float* offset, float* out,
                          cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  if (scale != nullptr) return launch_q<T, true>(x, n, d, ni, nj, m, scale, offset, out, stream);
  return launch_q<T, false>(x, n, d, ni, nj, m, scale, offset, out, stream);
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
