"""Fixed-capacity neighbor pools (GRNND §3.5).

A pool is a pair of tensors over all N vertices:

    ids   (N, R) int32    neighbor vertex ids, -1 marks an empty slot
    dists (N, R) float32  squared L2 distance to the owning vertex, +inf empty

The paper's atomic WARP_INSERT becomes a deterministic two-stage dataflow,
as in the JAX package's `core/pools.py`:

  1. `_stage`: a round's active (dst, src, dist) insertion requests are
     taken out, ordered by stable sorts (dst-major, dist-minor), capped per
     destination, and scattered into a per-vertex (N, cap) staging buffer
     (past `STAGE_BUDGET` active requests, over slices of destinations,
     bitwise the same);
  2. `ops.topr_merge`: per vertex, pool and staging are deduplicated and
     the R closest survive.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.core import vecstore as VS
from repro_torch.kernels import ops

# vertices per block of `_owner_dists`: bounds its two gathered
# (block * K, D) fp32 matrices (800 MB each at K = 24, D = 128)
OWNER_BLOCK = 1 << 16

# active requests staged in one pass at most (`_stage`). A pass holds up to
# ~60 bytes a request at once (the sorts' int64 permutations and double
# buffers, the gathered copies), ~8 GB at this budget; every staging of a
# 10^6-row build (N·P = N·R = 4.8·10^7 requests at R = P = 48, ~10-40% of
# them active) and every round of a 10^7-row build (~6·10^7 active of
# 4.8·10^8) stays one pass. Past it the active requests are staged over
# ranges of destinations, at most this many a slice
STAGE_BUDGET = 1 << 27


class Pool(NamedTuple):
    ids: torch.Tensor  # (N, R) int32
    dists: torch.Tensor  # (N, R) float32

    @property
    def n(self) -> int:
        return self.ids.shape[0]

    @property
    def r(self) -> int:
        return self.ids.shape[1]

    def degree(self) -> torch.Tensor:
        return (self.ids >= 0).sum(-1)


def empty_pool(n: int, r: int, device: str | torch.device = "cpu") -> Pool:
    return Pool(
        ids=torch.full((n, r), -1, dtype=torch.int32, device=device),
        dists=torch.full((n, r), torch.inf, dtype=torch.float32, device=device),
    )


def init_random(draws, x: torch.Tensor, s: int, r: int) -> Pool:
    """Random S-NN initialization (paper Alg. 3 lines 3-5).

    Each vertex gets S random neighbors from `draws.init_ids` (self-edges
    shifted off by one), with true distances, in an R-slot pool; repeats are
    removed and the pool sorted by the merge.
    """
    n = VS.nrows(x)
    if s > r:
        raise ValueError(f"s={s} must not exceed r={r}")
    raw = draws.init_ids(n, s).to(device=x.device, dtype=torch.int32)
    rows = torch.arange(n, dtype=torch.int32, device=x.device)[:, None]
    # map [0, n-1) onto [0, n) \ {v}: anything >= v shifts up by one
    ids = torch.where(raw >= rows, raw + 1, raw)
    dists = _owner_dists(x, rows[:, 0], ids)
    ids = F.pad(ids, (0, r - s), value=-1)
    dists = F.pad(dists, (0, r - s), value=torch.inf)
    return Pool(*ops.topr_merge(ids.contiguous(), dists.contiguous(), r))


def _owner_dists(x: torch.Tensor, owners: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """d(x[owner], x[id]) for a (B, K) id matrix; invalid ids -> +inf.

    Worked through in blocks of OWNER_BLOCK vertices; every row is
    independent, so the blocks give the same values as one pass.
    """
    b, k = ids.shape
    out = torch.empty((b, k), dtype=torch.float32, device=ids.device)
    for lo in range(0, b, OWNER_BLOCK):
        hi = min(b, lo + OWNER_BLOCK)
        idc = ids[lo:hi]
        xv = VS.take(x, owners[lo:hi]).repeat_interleave(k, dim=0)  # (B*K, D)
        nv = VS.take(x, idc.clamp_min(0).reshape(-1))  # (B*K, D)
        d = ops.rowwise_sqdist(xv, nv).reshape(hi - lo, k)
        out[lo:hi] = torch.where(idc >= 0, d, torch.inf)
    return out


class Requests(NamedTuple):
    """A flat batch of insertion requests: put `src` into `dst`'s pool."""

    dst: torch.Tensor  # (M,) int32, -1 = inactive
    src: torch.Tensor  # (M,) int32
    dist: torch.Tensor  # (M,) float32  d(dst, src)


def concat_requests(*reqs: Requests) -> Requests:
    return Requests(
        dst=torch.cat([r.dst for r in reqs]),
        src=torch.cat([r.src for r in reqs]),
        dist=torch.cat([r.dist for r in reqs]),
    )


def group_requests(req: Requests, n: int, cap: int, drop_self: bool = True):
    """Stage a flat Requests batch into per-destination (N, cap) buffers."""
    with trace.span("pools.stage"):
        return _stage(req.dst, req.src, req.dist, n, cap, drop_self=drop_self)


def stage_request_matrix(dst, src, dist, n: int, cap: int):
    """Stage a round's (N, P) request matrices: -> ids / dists (N, cap)."""
    with trace.span("pools.stage"):
        return _stage(dst.reshape(-1), src.reshape(-1), dist.reshape(-1), n, cap)


def _stage(dst, src_in, dist_in, n: int, cap: int, drop_self: bool = True,
           budget: int | None = None):
    """Stage requests into per-destination buffers: -> ids / dists (N, cap).

    Self-inserts (dst == src, where `drop_self`) and inactive requests (dst
    < 0) are dropped first: the active ones are taken out in request order
    (the host reads their count). They are ordered dist-minor / dst-major
    with two stable sorts, ranked within their destination segment, and the
    first `cap` per destination scattered; every repeat of a (dst, src) pair
    is dropped, so that repeats cannot crowd out distinct candidates at the
    cap. A dropped request only ever sorts behind every kept one, so the
    sorts of the active subsequence stage what sorts of the whole batch do.

    All of this happens within one destination's requests. So more than
    `budget` active requests (default `STAGE_BUDGET`; the argument is for
    tests) are staged over ranges of destinations, one slice at a time: a
    slice is the requests to its range, in their original order, so the
    stable sorts order every destination's requests as one pass does, and
    the staged ids and distances are bitwise the same at any slice count. Up
    to `budget` the one pass is the one slice [0, N).
    """
    budget = STAGE_BUDGET if budget is None else budget
    act = dst >= 0
    if drop_self:
        act &= dst != src_in
    at = torch.nonzero(act).squeeze(1)
    del act
    trace.count("pools.stage")  # the host reads the active count
    m = at.shape[0]
    trace.tally("pools/requests", dst.shape[0])
    trace.tally("pools/active", m)
    dst, src_in, dist_in = dst[at], src_in[at], dist_in[at]
    del at
    if m <= budget:
        parts = [_rank(dst, src_in, dist_in, 0, n, n, cap)]
    else:
        parts = _slices(dst, src_in, dist_in, n, cap, budget)
    dev = dst.device
    staged_ids = torch.full((n * cap + 1,), -1, dtype=torch.int32, device=dev)
    staged_dists = torch.full((n * cap + 1,), torch.inf, dtype=torch.float32, device=dev)
    for flat, src_s, dist_s in parts:
        staged_ids.scatter_(0, flat, src_s.int())
        staged_dists.scatter_(0, flat, dist_s.float())
        del flat, src_s, dist_s
    return staged_ids[:-1].view(n, cap), staged_dists[:-1].view(n, cap)


def _slices(dst, src_in, dist_in, n: int, cap: int, budget: int):
    """`_rank` over the ranges of `_slice_bounds`, each range's (active)
    requests taken out, in request order, only for its turn."""
    bounds, ranges = _slice_bounds(dst, n, budget)
    # the range of each request: k for destinations in ranges[k - 1]
    sid = torch.searchsorted(bounds.to(dst.dtype), dst, right=True, out_int32=True)
    for k, (lo, hi, size) in enumerate(ranges, start=1):
        if size == 0:
            continue
        with trace.span("pools.slice"):
            trace.tally("pools/slices")
            sel = torch.nonzero_static(sid == k, size=size).squeeze(1)
            part = _rank(dst[sel], src_in[sel], dist_in[sel], lo, hi, n, cap)
            del sel
        yield part


def _slice_bounds(dst, n: int, budget: int):
    """Ranges of destinations [lo, hi) that split requests to destinations
    `dst` (each in [0, n)) into slices of at most `budget`, greedily from
    destination 0 (a destination with more requests than that takes a range
    alone): (their bounds (K + 1,) on the card, [(lo, hi, requests)])."""
    dev = dst.device
    m = dst.shape[0]
    per_dst = torch.zeros(n, dtype=torch.int32, device=dev)
    per_dst.index_add_(0, dst, torch.ones_like(dst))
    ends = F.pad(per_dst.cumsum(0, dtype=torch.int64), (1, 0))  # requests below each
    lo = torch.zeros(1, dtype=torch.int64, device=dev)
    bounds = [lo]
    # consecutive greedy ranges hold more than `budget` together, so this
    # many steps reach n; past n every step stays there
    for _ in range(2 * (m // budget) + 2):
        hi = torch.searchsorted(ends, ends[lo] + budget, right=True) - 1
        lo = torch.maximum(hi, lo + 1).clamp_max(n)
        bounds.append(lo)
    bounds = torch.cat(bounds)
    trace.count("pools.stage")  # the host reads the ranges
    at, below = torch.stack([bounds, ends[bounds]]).tolist()
    k = at.index(n) + 1
    return bounds[:k], [(at[i], at[i + 1], below[i + 1] - below[i]) for i in range(k - 1)]


def _rank(dst, src_in, dist_in, lo: int, hi: int, n: int, cap: int):
    """The staging of requests to destinations in [lo, hi) (every other dst
    < 0): -> (slot of each in the (n·cap + 1,) staging buffer, n·cap for
    those dropped; src; dist), in the stage order."""
    dev = dst.device

    # dedup identical (dst, src) requests: sort src-minor / dst-major and
    # invalidate repeats
    o1 = torch.argsort(src_in, stable=True)
    o2 = torch.argsort(torch.where(dst >= 0, dst, hi)[o1], stable=True)
    dperm = o1[o2]
    del o1, o2
    dst_p, src_p = dst[dperm], src_in[dperm]
    dup = torch.zeros_like(dst_p, dtype=torch.bool)
    dup[1:] = (dst_p[1:] == dst_p[:-1]) & (src_p[1:] == src_p[:-1]) & (dst_p[1:] >= 0)
    del src_p
    dst = torch.empty_like(dst)
    dst[dperm] = torch.where(dup, -1, dst_p)  # dperm is a permutation
    del dperm, dst_p, dup

    dist = torch.where(dst >= 0, dist_in, torch.inf)
    dst_key = torch.where(dst >= 0, dst, hi)  # inactive sorts to the end
    del dst

    # stable composed sort: dist-minor, then dst-major
    order1 = torch.argsort(dist, stable=True)
    order2 = torch.argsort(dst_key[order1], stable=True)
    perm = order1[order2]
    del order1, order2
    dst_s, src_s, dist_s = dst_key[perm], src_in[perm], dist[perm]
    del perm, dst_key, dist

    # rank within each destination segment. dst_s is sorted, so segment v
    # starts at the first position holding v: one binary search per key
    # value gives the starts the reference's max-scan gives (on the card,
    # torch.cummax over the N·P entries took three quarters of a round and
    # a histogram of them, whose atomics collide on sorted keys, 40%)
    keys = torch.arange(lo, hi + 1, dtype=dst_s.dtype, device=dev)
    row = dst_s.long()
    seg_start = torch.searchsorted(dst_s, keys)[row - lo if lo else row]
    rank = torch.arange(dst_s.shape[0], device=dev) - seg_start
    del keys, seg_start

    # the kept requests' slots; the rest go to one extra slot, dropped after
    keep = (rank < cap) & (dst_s < hi)
    flat = torch.where(keep, row * cap + rank, n * cap)
    return flat, src_s, dist_s


def merge_into(pool: Pool, cand_ids: torch.Tensor, cand_dists: torch.Tensor) -> Pool:
    """pool ∪ candidates -> R closest unique (the WARP_INSERT analogue)."""
    with trace.span("pools.merge"):
        ids = torch.cat([pool.ids, cand_ids], dim=-1)
        dists = torch.cat([pool.dists, cand_dists], dim=-1)
        return Pool(*ops.topr_merge(ids, dists, pool.r))


def insert_requests(pool: Pool, req: Requests, cap: int | None = None) -> Pool:
    """Group a request batch and merge it into the pool (both stages)."""
    cap = cap if cap is not None else pool.r
    staged_ids, staged_dists = group_requests(req, pool.n, cap)
    del req  # dead once staged: not held through the merge
    return merge_into(pool, staged_ids, staged_dists)


def build_requests_into_empty(n: int, r: int, req: Requests, cap: int | None = None) -> Pool:
    """Materialize a fresh pool (the cleared write buffer) from requests only."""
    cap = cap if cap is not None else r
    staged_ids, staged_dists = group_requests(req, n, max(cap, r))
    return Pool(*ops.topr_merge(staged_ids.contiguous(), staged_dists.contiguous(), r))
