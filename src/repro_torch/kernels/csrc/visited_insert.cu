// The hashed visited set's insert: (Q, R) ids into (Q, H) open-addressed
// tables, in place, one launch a beam step.
//
// No Pallas counterpart: the JAX package runs it as a fori_loop over the R
// columns (src/repro/core/search.py::_table_insert), and the port's plain
// version (repro_torch/kernels/ref.py::visited_insert_ref) as a Python loop
// of about seven torch ops a column, ~14,000 small launches a search.
//
// Semantics, exactly the loop's: for each query, columns 0..R-1 in order,
// skip v < 0; the window is slots (max(v, 0) % H + l) % H, l < 8 (it wraps
// and repeats slots when H < 8); if no slot of it holds v and one holds -1,
// v goes into the first such slot in probe order, else it is dropped (a
// capacity miss).
//
// The columns of a query are a chain only through the table: what column
// k reads is the table at the start of the step plus the writes of columns
// before k, and those writes are known to the query's lanes as they are
// made. So the kernel does not wait on one read a column. Design: one
// 8-lane group a query, 4 queries a warp, the columns taken BATCH at a
// time. For a batch, every lane loads its slot of every column's window
// (lane l: slot l) before it looks at any; the pass over the batch's
// columns then runs in registers: two ballots give each group found /
// empty, __ffs the first empty slot in probe order, one lane writes, and
// every lane sets its loaded value of each later column of the batch whose
// slot is the one written. The 4 groups of a warp step through the columns
// together (whole-warp ballots, the write predicated), since groups that
// branch on their own ids issue one at a time; the pass over later columns
// runs only when some group of the warp wrote, and each id's home slot is
// hashed once, by one lane. The next batch's loads follow a __syncwarp
// after the writes and go through L2 (relaxed gpu-scope PTX), so they see
// them. A query at R = 48 waits on 3 rounds of loads, not 48.
#include "common.cuh"

#define HASH_PROBES 8
// Columns a batch: three registers each a lane (id, slot, loaded value).
// At 16 the kernel holds at most 80 registers (24 warps an SM), so the
// 2,500 warps of Q = 10^4 queries are all resident at once.
constexpr int BATCH = 16;

__device__ __forceinline__ int load_slot(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_slot(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__global__ void __launch_bounds__(256)
    visited_insert_kernel(int* __restrict__ table, long long q, int h,
                          const int* __restrict__ ids, int r) {
  const int lane = threadIdx.x & 31;
  const int l = lane & (HASH_PROBES - 1);
  const int base = lane - l;
  const long long qq = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / HASH_PROBES;
  // a group past the last query stays, with nothing live, for the
  // whole-warp ballots and shuffles
  const bool here = qq < q;
  int* tab = table + (here ? qq : 0) * h;
  const int* row = ids + (here ? qq : 0) * r;
  for (int c0 = 0; c0 < r; c0 += BATCH) {
    // the batch's ids and their home slots v % H, BATCH / 8 a lane (one
    // modulo each), broadcast to the group; then every column's window
    // slot of this lane, all loads in flight at once
    int mine[BATCH / HASH_PROBES], home[BATCH / HASH_PROBES];
#pragma unroll
    for (int i = 0; i < BATCH / HASH_PROBES; ++i) {
      const int c = c0 + i * HASH_PROBES + l;
      mine[i] = here && c < r ? __ldg(row + c) : -1;
      home[i] = mine[i] >= 0 ? mine[i] % h : 0;
    }
    int v[BATCH], p[BATCH], val[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      v[k] = __shfl_sync(REPRO_FULL_MASK, mine[k / HASH_PROBES], k % HASH_PROBES, HASH_PROBES);
      int t = __shfl_sync(REPRO_FULL_MASK, home[k / HASH_PROBES], k % HASH_PROBES, HASH_PROBES);
      t += l;  // below H + 8: one subtraction wraps it when H >= 8
      if (t >= h) t = h >= HASH_PROBES ? t - h : t % h;
      p[k] = v[k] >= 0 ? t : -1;
      val[k] = v[k] >= 0 ? load_slot(tab + p[k]) : 0;
    }
    // the columns in order, on the loaded values. The 4 groups of a warp
    // step together (whole-warp ballots, a predicated write): groups left
    // to branch on their own ids would issue one at a time
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const bool live = v[k] >= 0;
      const unsigned found =
          (__ballot_sync(REPRO_FULL_MASK, live && val[k] == v[k]) >> base) & 0xffu;
      const unsigned empty =
          (__ballot_sync(REPRO_FULL_MASK, live && val[k] == -1) >> base) & 0xffu;
      const int w = __ffs(empty) - 1;  // the first empty slot in probe order
      const bool ins = found == 0u && empty != 0u;  // live: empty != 0 needs it
      if (__any_sync(REPRO_FULL_MASK, ins)) {  // most columns write nowhere in the warp
        const int at = __shfl_sync(REPRO_FULL_MASK, p[k], base + max(w, 0));
        if (ins && l == w) store_slot(tab + at, v[k]);
        const int s = ins ? at : -2;
#pragma unroll
        for (int j = k + 1; j < BATCH; ++j)
          if (p[j] == s) val[j] = v[k];
      }
    }
    __syncwarp();  // this batch's writes before the next batch's loads
  }
}

extern "C" int visited_insert_launch(int* table, long long q, int h, const int* ids, int r,
                                     cudaStream_t stream) {
  if (q == 0 || r == 0) return cudaSuccess;
  if (h < 1) return cudaErrorInvalidValue;
  const long long blocks = (q * HASH_PROBES + 255) / 256;
  visited_insert_kernel<<<(unsigned)blocks, 256, 0, stream>>>(table, q, h, ids, r);
  return cudaGetLastError();
}
