// Per-row dedup + top-r-by-distance merge (the pool merge and the beam merge).
//
// Replaces the TPU kernel src/repro/kernels/topr_merge.py::topr_merge_pallas
// (body _topr_merge_kernel). Semantics: repro_torch/kernels/ref.py::topr_merge_ref.
//
// Bound: the B*W*8 bytes read and B*r*8 written. The first port's kernel
// made two O(W^2) passes over shared memory per row (a dedup scan and a rank
// count: ~14k comparisons a row at W = 96, ~470k at W = 560), and so was
// bound by those comparisons, 9x over the bytes at the build's shape and 53x
// at W = 560. This design replaces both passes with work held in registers:
//   1. a group of L threads takes a row, 8 entries a thread in blocked order
//      (entry i on thread i / 8), padded with empties to N = 8L, the power
//      of two at or above W (L = 16 at W = 96: two rows a warp);
//   2. dedup: every live id goes into an open-addressed table of 2N slots in
//      shared memory, one 64-bit word (id, position) a slot, claimed with
//      atomicCAS; atomicMin keeps the lowest position per id, and an entry
//      survives when the table holds its own position;
//   3. a survivor with a finite distance gets the 64-bit key (order-
//      preserving bits of the distance, position), every other entry the
//      largest key. Keys are distinct, so any sort of them gives exactly the
//      oracle's stable order by (distance, position);
//   4. most rows of the build's merge are sparse (on average 25-40 live keys
//      of 96): when the fullest row of a warp has at most L, 2L or 4L live
//      keys, the rows' live keys are packed (a scan over each row's lanes)
//      and only 1, 2 or 4 keys a thread are sorted;
//   5. the sort is a bitonic network without directions (the lower index
//      always takes the minimum), in registers for partners on the same
//      thread, by __shfl_xor_sync within a warp, and through shared memory
//      (the table's space) only when a row spans warps (W > 256);
//   6. rank i goes to output slot i: the id and distance are read back from
//      the row by position, empties become (-1, +inf), 16-byte stores where
//      aligned.
// The beam merge's variant (FLAGS) also carries each of the first F entries'
// expanded flag to the slot it lands in, read back by the same position: a
// survivor past F, new to the row, gets 0; an empty slot gets 1. Without
// FLAGS the flag operands are never touched and the kernel is the plain one.
// The work is integer compares and selects on 64-bit keys, and they, not the
// bytes, bound the kernel at these shapes (PERF.md). NaN and infinite
// distances are treated as empty slots (the oracle sorts NaN last); the
// build and search never produce them.
#include "common.cuh"

namespace {

constexpr int E_IN = 8;  // entries a thread loads
using u64 = unsigned long long;
constexpr u64 EMPTY = ~0ull;  // an empty table slot, and the key of an empty entry

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v >> 1); }

// Order-preserving bits of a finite float (-0 taken as +0, so equal values
// tie on position alone, as in a stable sort).
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int L>
__device__ __forceinline__ void sync_group() {
  if constexpr (L <= 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Insert (id, pos) into the row's table; returns the slot that holds id.
template <int T>
__device__ __forceinline__ int table_insert(u64* tab, int id, int pos) {
  const u64 mine = ((u64)(unsigned)id << 32) | (unsigned)pos;
  int h = (int)(((unsigned)id * 0x9E3779B1u) >> (32 - ilog2(T)));
  while (true) {
    const u64 cur = atomicCAS(&tab[h], EMPTY, mine);
    if (cur == EMPTY) return h;
    if ((unsigned)(cur >> 32) == (unsigned)id) {
      atomicMin(&tab[h], mine);
      return h;
    }
    h = (h + 1) & (T - 1);
  }
}

__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a < b ? b : a; }

// Ascending bitonic sort of the N = E*L keys of a group (E keys a thread),
// entry i = g*E + e in key[e] of thread g, in the form without directions: the first stage of
// each merge of width k pairs i with i ^ (k - 1), every later stage i with
// i ^ j, and the lower index always takes the minimum. `xbuf` (N words;
// used only when L > 32) holds entry i at (i % E) * L + i / E, so the
// exchanges are free of bank conflicts.
template <int L, int E>
__device__ __forceinline__ void bitonic_sort(u64 (&key)[E], int g, u64* xbuf) {
  constexpr int LOGN = ilog2(E * L);
#pragma unroll
  for (int lk = 1; lk <= LOGN; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      const bool first = lj == lk - 1;
      if (j < E) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int f = first ? e ^ (k - 1) : e ^ j;
          if (f > e) {
            const u64 a = key[e], b = key[f];
            key[e] = umin(a, b);
            key[f] = umax(a, b);
          }
        }
      } else {
        const int m = first ? k / E - 1 : j / E;  // partner thread g ^ m
        const bool keep_min = ((g * E) & j) == 0;
        u64 o[E];
        if (m < 32) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            o[e] = __shfl_xor_sync(REPRO_FULL_MASK, key[first ? E - 1 - e : e], m);
        } else {
          __syncthreads();
#pragma unroll
          for (int e = 0; e < E; ++e) xbuf[e * L + g] = key[e];
          __syncthreads();
#pragma unroll
          for (int e = 0; e < E; ++e) o[e] = xbuf[(first ? E - 1 - e : e) * L + (g ^ m)];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) key[e] = keep_min ? umin(key[e], o[e]) : umax(key[e], o[e]);
      }
    }
  }
}

// The flag operands of the FLAGS variant: the row's first F input flags
// and its r output flags.
struct RowFlags {
  const uint8_t* in;
  int f;
  uint8_t* out;
};

// Rank i = g*E + e of a sorted group -> output slot i (ranks past the
// group's entries, when r > E*L, are empty): the id and distance (and under
// FLAGS the flag) are read back from the row by position, 16-byte (flags:
// 4-byte) stores where aligned.
template <int L, int E, bool FLAGS>
__device__ __forceinline__ void write_ranks(const u64 (&key)[E], int g, const int* ids_r,
                                            const float* d_r, int r, bool vec_out, int* oi_r,
                                            float* od_r, RowFlags fl) {
  int oi[E];
  float od[E];
  uint8_t of[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool live = key[e] != EMPTY;
    const int pos = (int)(key[e] & 0xffffffffu);
    oi[e] = live ? __ldg(ids_r + pos) : -1;
    od[e] = live ? __ldg(d_r + pos) : CUDART_INF_F;
    if constexpr (FLAGS) of[e] = !live ? 1 : pos < fl.f ? __ldg(fl.in + pos) : 0;
  }
  const int p0 = g * E;
  if (E % 4 == 0 && vec_out && p0 + E <= r) {
#pragma unroll
    for (int h = 0; h < E; h += 4) {
      *reinterpret_cast<int4*>(oi_r + p0 + h) = make_int4(oi[h], oi[h + 1], oi[h + 2], oi[h + 3]);
      *reinterpret_cast<float4*>(od_r + p0 + h) =
          make_float4(od[h], od[h + 1], od[h + 2], od[h + 3]);
      if constexpr (FLAGS)
        *reinterpret_cast<uchar4*>(fl.out + p0 + h) =
            make_uchar4(of[h], of[h + 1], of[h + 2], of[h + 3]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (p0 + e < r) {
        oi_r[p0 + e] = oi[e];
        od_r[p0 + e] = od[e];
        if constexpr (FLAGS) fl.out[p0 + e] = of[e];
      }
    }
  }
  for (int o = E * L + g; o < r; o += L) {
    oi_r[o] = -1;
    od_r[o] = CUDART_INF_F;
    if constexpr (FLAGS) fl.out[o] = 1;
  }
}

// The live keys of a group, packed in position order into `xbuf` (whose
// rows' tables are no longer read), sorted E keys a thread, written out.
template <int L, int E, bool FLAGS>
__device__ __forceinline__ void sort_packed(const u64* xbuf, int g, bool active, const int* ids_r,
                                            const float* d_r, int r, bool vec_out, int* oi_r,
                                            float* od_r, RowFlags fl) {
  u64 key[E];
#pragma unroll
  for (int e = 0; e < E; ++e) key[e] = xbuf[g * E + e];
  bitonic_sort<L, E>(key, g, nullptr);
  if (active) write_ranks<L, E, FLAGS>(key, g, ids_r, d_r, r, vec_out, oi_r, od_r, fl);
}

// Rows a block takes: 256 threads in groups of L, or one row of L threads.
template <int L>
__host__ __device__ constexpr int rows_per_block() {
  return L >= 256 ? 1 : 256 / L;
}

template <int L, bool FLAGS>
__global__ void __launch_bounds__(L > 256 ? L : 256)
    topr_merge_kernel(const int* __restrict__ ids, const float* __restrict__ dists, long long b,
                      int w, int r, bool vec_in, bool vec_out, int* __restrict__ out_ids,
                      float* __restrict__ out_dists, const uint8_t* __restrict__ flags, int f,
                      uint8_t* __restrict__ out_flags) {
  constexpr int E = E_IN, N = E * L, T = 2 * N, RPB = rows_per_block<L>();
  extern __shared__ __align__(16) u64 tab_all[];
  const int grp = threadIdx.x / L, g = threadIdx.x % L;
  const long long row = (long long)blockIdx.x * RPB + grp;
  const bool active = row < b;
  u64* tab = tab_all + (size_t)grp * T;
  const int* ids_r = ids + (active ? row : 0) * w;
  const float* d_r = dists + (active ? row : 0) * w;
  int* oi_r = out_ids + (active ? row : 0) * r;
  float* od_r = out_dists + (active ? row : 0) * r;
  RowFlags fl{};
  if constexpr (FLAGS) fl = {flags + (active ? row : 0) * f, f, out_flags + (active ? row : 0) * r};

#pragma unroll
  for (int t = 0; t < 2 * E; ++t) tab[t * L + g] = EMPTY;

  // 1. this thread's entries g*E .. g*E + 7, empties past W
  int id[E];
  float dd[E];
  const int p0 = g * E;
  if (active && vec_in && p0 + E <= w) {
#pragma unroll
    for (int h = 0; h < E; h += 4) {
      const int4 i4 = __ldg(reinterpret_cast<const int4*>(ids_r + p0 + h));
      const float4 d4 = __ldg(reinterpret_cast<const float4*>(d_r + p0 + h));
      id[h] = i4.x, id[h + 1] = i4.y, id[h + 2] = i4.z, id[h + 3] = i4.w;
      dd[h] = d4.x, dd[h + 1] = d4.y, dd[h + 2] = d4.z, dd[h + 3] = d4.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool in = active && p0 + e < w;
      id[e] = in ? __ldg(ids_r + p0 + e) : -1;
      dd[e] = in ? __ldg(d_r + p0 + e) : CUDART_INF_F;
    }
  }
  sync_group<L>();

  // 2. dedup: the lowest position of each id survives
  int slot[E];
#pragma unroll
  for (int e = 0; e < E; ++e) slot[e] = id[e] >= 0 ? table_insert<T>(tab, id[e], p0 + e) : 0;
  sync_group<L>();

  // 3. keys
  u64 key[E];
  unsigned live = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const u64 mine = ((u64)(unsigned)id[e] << 32) | (unsigned)(p0 + e);
    const bool ok = id[e] >= 0 && isfinite(dd[e]) && tab[slot[e]] == mine;
    key[e] = ok ? ((u64)ordered_bits(dd[e]) << 32) | (unsigned)(p0 + e) : EMPTY;
    live |= (unsigned)ok << e;
  }

  // 4. rows of 8 to 32 lanes: when the fullest row of the warp has at most
  // L, 2L or 4L live keys, pack each row's live keys (a scan over the row's
  // lanes gives each key a place; a sort needs no particular order) and
  // sort 1, 2 or 4 keys a thread instead of 8. Every row's live total comes
  // from one warp sum, a field of 32 / (rows a warp) bits each, so a warp of
  // full rows pays one reduction for the test.
  if constexpr (L >= 8 && L <= 32) {
    constexpr int RPW = 32 / L, FB = 32 / RPW;
    const int cnt = __popc(live);
    const unsigned sums = __reduce_add_sync(REPRO_FULL_MASK, (unsigned)cnt << (FB * (grp % RPW)));
    int need = 0;
#pragma unroll
    for (int q = 0; q < RPW; ++q) need = max(need, (int)((sums >> (FB * q)) & ((1ull << FB) - 1)));
    if (need <= 4 * L) {
      const int total = (int)((sums >> (FB * (grp % RPW))) & ((1ull << FB) - 1));
      int incl = cnt;
#pragma unroll
      for (int off = 1; off < L; off <<= 1) {
        const int o = __shfl_up_sync(REPRO_FULL_MASK, incl, off, L);
        if (g >= off) incl += o;
      }
      __syncwarp();  // every keep test has read the table
      int k = incl - cnt;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if ((live >> e) & 1u) tab[k++] = key[e];
      const int fill = need <= L ? L : need <= 2 * L ? 2 * L : 4 * L;
      for (int t = total + g; t < fill; t += L) tab[t] = EMPTY;
      __syncwarp();
      if (need <= L)
        sort_packed<L, 1, FLAGS>(tab, g, active, ids_r, d_r, r, vec_out, oi_r, od_r, fl);
      else if (need <= 2 * L)
        sort_packed<L, 2, FLAGS>(tab, g, active, ids_r, d_r, r, vec_out, oi_r, od_r, fl);
      else
        sort_packed<L, 4, FLAGS>(tab, g, active, ids_r, d_r, r, vec_out, oi_r, od_r, fl);
      return;
    }
  }

  // 5. all N keys (the shared-memory stages of a row across warps reuse
  // the table), rank i -> output slot i
  bitonic_sort<L, E>(key, g, tab);
  if (active) write_ranks<L, E, FLAGS>(key, g, ids_r, d_r, r, vec_out, oi_r, od_r, fl);
}

template <int L, bool FLAGS>
cudaError_t launch(const int* ids, const float* dists, long long b, int w, int r, bool vec_in,
                   bool vec_out, int* out_ids, float* out_dists, const uint8_t* flags, int f,
                   uint8_t* out_flags, cudaStream_t stream) {
  constexpr int RPB = rows_per_block<L>();
  constexpr int threads = L > 256 ? L : 256;
  const size_t smem = (size_t)RPB * 2 * E_IN * L * sizeof(u64);
  cudaError_t err = allow_smem(topr_merge_kernel<L, FLAGS>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (b + RPB - 1) / RPB;
  topr_merge_kernel<L, FLAGS><<<(unsigned)blocks, threads, smem, stream>>>(
      ids, dists, b, w, r, vec_in, vec_out, out_ids, out_dists, flags, f, out_flags);
  return cudaGetLastError();
}

template <bool FLAGS>
int dispatch(const int* ids, const float* dists, long long b, int w, int r, int* out_ids,
             float* out_dists, const uint8_t* flags, int f, uint8_t* out_flags,
             cudaStream_t stream) {
  if (b == 0) return cudaSuccess;
  const bool vec_in = w % 4 == 0 && aligned_to(ids, 16) && aligned_to(dists, 16);
  const bool vec_out = r % 4 == 0 && aligned_to(out_ids, 16) && aligned_to(out_dists, 16) &&
                       (!FLAGS || aligned_to(out_flags, 4));
  int l = 1;  // the group width: N = 8L entries, the power of two at or above W
  while (E_IN * l < w) l <<= 1;
  switch (l) {
#define REPRO_TOPR_CASE(L_)                                                                   \
  case L_:                                                                                    \
    return launch<L_, FLAGS>(ids, dists, b, w, r, vec_in, vec_out, out_ids, out_dists, flags, \
                             f, out_flags, stream);
    REPRO_TOPR_CASE(1)
    REPRO_TOPR_CASE(2)
    REPRO_TOPR_CASE(4)
    REPRO_TOPR_CASE(8)
    REPRO_TOPR_CASE(16)
    REPRO_TOPR_CASE(32)
    REPRO_TOPR_CASE(64)
    REPRO_TOPR_CASE(128)
    REPRO_TOPR_CASE(256)
    REPRO_TOPR_CASE(512)
    REPRO_TOPR_CASE(1024)
#undef REPRO_TOPR_CASE
    default:
      return cudaErrorInvalidValue;  // W > 8192
  }
}

}  // namespace

extern "C" int topr_merge_launch(const int* ids, const float* dists, long long b, int w, int r,
                                 int* out_ids, float* out_dists, cudaStream_t stream) {
  return dispatch<false>(ids, dists, b, w, r, out_ids, out_dists, nullptr, 0, nullptr, stream);
}

// The beam merge: also (B, F) input flags (F <= W, one byte each) of the
// first F entries, carried to the (B, r) output flags by surviving position.
extern "C" int topr_merge_flags_launch(const int* ids, const float* dists, long long b, int w,
                                       int r, const uint8_t* flags, int f, int* out_ids,
                                       float* out_dists, uint8_t* out_flags, cudaStream_t stream) {
  return dispatch<true>(ids, dists, b, w, r, out_ids, out_dists, flags, f, out_flags, stream);
}
