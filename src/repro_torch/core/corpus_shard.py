"""Corpus-sharded index: each shard owns 1/S of every O(N) operand.

A port of the JAX package's `core/corpus_shard.py`. Shard s of S owns the
contiguous rows [s·n_loc, (s+1)·n_loc) of the vectors, graph rows,
validity mask, label words, rescore tier and layout `ids_map`; per-query
state (beam, visited set, result heap) is O(Q) and replicated.

  * `n_loc = ceil(N / S)`; global id g lives on shard `g // n_loc` at local
    row `g % n_loc` (`shard_of` / `local_of` / `global_of`, whose round
    trip is the identity). The last shard may own fewer than n_loc real
    rows; its padded tail is unreachable.
  * Graph rows are sharded by owner row and keep global neighbor ids, so an
    edge across a shard boundary needs no rewriting. `shard_optimized`
    slices an `OptimizedIndex` along its permuted rows, each shard owning
    its slice of `inv`.

The search is the one beam loop, `search._traverse`; the sharded search
supplies its two steps that read O(N) state (`run_sharded`). The fetch of
a selected vertex's graph row is an owner-combine of the shards' rows.
The expand runs B3 on each shard's own slice (neighbors it does not own
masked to -1, an empty slot) against a (Q, 1) table of -1, so its `fresh`
is the live mask, and combines the per-slot outputs with order-free
owner-combines: min for distances (+inf from non-owners), max for ids (-1
from non-owners) and flags; freshness against the visited set is then
taken on global ids (`search._table_member`). Exactly one shard
contributes per slot, so no fp sum is re-associated: the sharded search is
bitwise `core.search.search`, for any shard count. After the loop each
shard re-ranks and maps the ids it owns.

In process (`group=None`) the combines fold the S local contributions;
under a `torch.distributed` group each rank keeps its own shard and the
combines are `all_reduce` MIN / MAX.

The build (`sharded_build`, the divide-and-conquer recipe): per-partition
GRNND builds give a block-diagonal pool; each merge round injects random
candidates from other shards with their true distances (`gather_sqdist`),
stages them, and runs one localized propagation round over every vertex
(`dynamic._localized_round`), then a reverse-edge pass between rounds.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core import labels as L
from repro_torch.core import pools as P
from repro_torch.core import vecstore as VS
from repro_torch.core.draws import Draws
from repro_torch.core.grnnd import GRNNDConfig, build_graph, reverse_edge_round
from repro_torch.core.search import (
    SearchResult,
    _rescore_merge,
    _search_args,
    _table_member,
    _traverse,
    medoid,
)
from repro_torch.kernels import ops

__all__ = [
    "CorpusShardedIndex",
    "shard",
    "shard_optimized",
    "sharded_search",
    "sharded_build",
    "shard_bounds",
    "shard_of",
    "local_of",
    "global_of",
    "memory_report",
]


# ---------------------------------------------------------------------------
# partition layout and id maps
# ---------------------------------------------------------------------------


def shard_bounds(n: int, n_shards: int) -> tuple[tuple[int, ...], int]:
    """(row0 per shard, n_loc) of the contiguous equal partition of [0, n):
    `n_loc = ceil(n / n_shards)`; shard s owns [row0_s, min(row0_s + n_loc, n))."""
    if n_shards < 1 or n < 1:
        raise ValueError(f"need n >= 1 and n_shards >= 1, got {n}, {n_shards}")
    n_loc = -(-n // n_shards)
    return tuple(s * n_loc for s in range(n_shards)), n_loc


def shard_of(g, n_loc: int):
    """Owning shard of global id(s) g."""
    return g // n_loc


def local_of(g, n_loc: int):
    """Local row of global id(s) g on its owning shard."""
    return g % n_loc


def global_of(s, loc, n_loc: int):
    """Global id of local row `loc` on shard `s` (the inverse of the above)."""
    return s * n_loc + loc


# ---------------------------------------------------------------------------
# the sharded index
# ---------------------------------------------------------------------------


class CorpusShardedIndex(NamedTuple):
    """Per-shard stacked operands, each (S, n_loc, ...) on one device.

    `data` holds the traversal tier's stored rows (fp32 / bf16 / int8);
    `scale` / `offset` are the frozen (D,) quantizer parameters. `graphs`
    rows carry global neighbor ids. `rescores` is the dequantized fp32
    tier, or under `shard(tier="host")` a `vecstore.HostTier` over the
    unstacked (N, D) tier (the flattened stack index is the global id).
    `entry_row` / `entry_valid` / `entry_words` are the entry vertex's
    owner-side state, taken at `shard()` time.
    """

    data: torch.Tensor  # (S, n_loc, D) stored rows
    scale: torch.Tensor | None  # (D,)
    offset: torch.Tensor | None  # (D,)
    graphs: torch.Tensor  # (S, n_loc, R) int32, global ids
    row0s: torch.Tensor  # (S,) int32, first global row
    valids: torch.Tensor | None  # (S, n_loc) bool
    rescores: object | None  # (S, n_loc, D) fp32, or a HostTier
    vwords: torch.Tensor | None  # (S, n_loc, W) packed label words
    ids_maps: torch.Tensor | None  # (S, n_loc) int32 layout inv slice
    entry: torch.Tensor  # () int32 global entry id
    entry_row: torch.Tensor  # (D,) fp32 dequantized entry row
    entry_valid: torch.Tensor | None  # () bool
    entry_words: torch.Tensor | None  # (W,)
    n: int  # true corpus size

    @property
    def n_shards(self) -> int:
        return int(self.data.shape[0])

    @property
    def n_loc(self) -> int:
        return int(self.data.shape[1])

    def search(self, queries, **kw) -> SearchResult:
        return sharded_search(self, queries, **kw)


def _stack_shards(a: torch.Tensor, row0s: Sequence[int], n_loc: int, fill) -> torch.Tensor:
    """Rows of `a` as (S, n_loc, ...) with `fill`-padded tails."""
    n = a.shape[0]
    out = torch.full((len(row0s), n_loc, *a.shape[1:]), fill, dtype=a.dtype, device=a.device)
    for s, row0 in enumerate(row0s):
        m = min(n_loc, n - row0)
        out[s, :m] = a[row0 : row0 + m]
    return out


def shard(
    x,
    graph,
    n_shards: int,
    *,
    valid=None,
    rescore=None,
    labels=None,
    ids_map=None,
    entry=None,
    tier: str = "device",
    device="cuda",
) -> CorpusShardedIndex:
    """Partition a built index into a `CorpusShardedIndex` on `device`.

    `x` is the traversal tier (tensor or `VectorStore`), `graph` a `Pool`
    or (N, R) id array; `valid` / `rescore` / `labels` / `ids_map` are the
    optional operands `core.search.search` takes, each sliced to its owner
    shard. `entry` defaults to the medoid of the whole corpus. `tier`
    places the fp32 rescore tier: "device" slices it per shard, "host"
    keeps it whole in host memory behind a `vecstore.HostTier`.
    """
    if tier not in VS.PLACEMENTS:
        raise ValueError(f"tier must be one of {VS.PLACEMENTS}, got {tier!r}")
    dev = _device.resolve(device)
    x = VS.to_device(x, dev)
    gids = _device.put(graph.ids if hasattr(graph, "ids") else graph, torch.int32, dev)
    n = VS.nrows(x)
    if gids.shape[0] != n:
        raise ValueError(f"graph has {gids.shape[0]} rows for {n} vectors")
    row0s, n_loc = shard_bounds(n, n_shards)
    if valid is not None:
        valid = _device.put(valid, torch.bool, dev)
    entry = medoid(x, valid) if entry is None else _device.put(entry, torch.int32, dev)
    entry_row = VS.take(x, entry.reshape(1))[0]

    xd, xs, xo = VS.parts(x)
    vwords = None if labels is None else _device.put(L.store_words(labels), torch.int32, dev)
    # the dequantized exact tier: the owner-side re-rank reads the rows the
    # replicated `VS.take(rescore, ·)` gathers
    resc_field = None
    if rescore is not None and tier == "host":
        # kept unstacked in host memory: the HostTier gathers by global id,
        # which is the flattened stack index under contiguous partitions
        resc_field = rescore if VS.is_host(rescore) else VS.HostTier(rescore)
    elif rescore is not None:
        src = rescore.data if VS.is_host(rescore) else rescore
        resc_field = _stack_shards(VS.dequant(VS.to_device(src, dev)), row0s, n_loc, 0)
    if ids_map is not None:
        ids_map = _device.put(ids_map, torch.int32, dev)
    return CorpusShardedIndex(
        data=_stack_shards(xd, row0s, n_loc, 0),
        scale=xs,
        offset=xo,
        graphs=_stack_shards(gids, row0s, n_loc, -1),
        row0s=torch.tensor(row0s, dtype=torch.int32, device=dev),
        valids=None if valid is None else _stack_shards(valid, row0s, n_loc, False),
        rescores=resc_field,
        vwords=None if vwords is None else _stack_shards(vwords, row0s, n_loc, 0),
        ids_maps=None if ids_map is None else _stack_shards(ids_map, row0s, n_loc, -1),
        entry=entry,
        entry_row=entry_row,
        entry_valid=None if valid is None else valid[entry.long()],
        entry_words=None if vwords is None else vwords[entry.long()],
        n=n,
    )


def shard_optimized(opt, n_shards: int, tier: str = "device", device=None) -> CorpusShardedIndex:
    """Partition a `layout.OptimizedIndex`: shards slice its permuted rows,
    each owning its slice of `inv`, so ids come back in the original
    numbering. `device` defaults to the index's."""
    return shard(
        opt.x,
        opt.graph_ids,
        n_shards,
        valid=opt.valid,
        rescore=opt.rescore,
        labels=opt.vwords,
        ids_map=opt.inv,
        entry=opt.entry,
        tier=tier,
        device=opt.graph_ids.device if device is None else device,
    )


# ---------------------------------------------------------------------------
# owner-combines
# ---------------------------------------------------------------------------


def _reduce(a: torch.Tensor, group, op) -> torch.Tensor:
    if group is not None:
        torch.distributed.all_reduce(a, op=op, group=group)
    return a


def _cmin(parts, group):
    """Min over the local shards' contributions, then over the group's
    ranks. Non-owners contribute +inf: one finite value survives a slot."""
    a = functools.reduce(torch.minimum, parts).contiguous()
    return _reduce(a, group, torch.distributed.ReduceOp.MIN)


def _cmax_i32(parts, group):
    """Max over int32 contributions (non-owners contribute -1)."""
    a = functools.reduce(torch.maximum, parts).contiguous()
    return _reduce(a, group, torch.distributed.ReduceOp.MAX)


def _cor(parts, group):
    """Logical OR across shards (non-owners contribute False), carried as
    int32 through the group's MAX."""
    a = functools.reduce(torch.logical_or, parts)
    if group is None:
        return a
    return _reduce(a.to(torch.int32), group, torch.distributed.ReduceOp.MAX).bool()


def _owner(ids, row0: int, n_own: int, n_loc: int):
    """(owned mask, clamped local rows) of global `ids` for one shard."""
    loc = ids - row0
    owned = (ids >= 0) & (loc >= 0) & (loc < n_own)
    return owned, loc.clamp(0, n_loc - 1).long()


# ---------------------------------------------------------------------------
# the corpus-sharded search: `search._traverse` with a shard-local fetch and expand
# ---------------------------------------------------------------------------


def run_sharded(
    index: CorpusShardedIndex, queries, fwords, *, k, ef, max_steps, visited, visited_cap, group
) -> SearchResult:
    """The executor of `sharded_search`: arguments arrive normalized
    (queries on the index's device, the filter packed to (Q, W) words, ef
    widened, the table size resolved). Under a group of `index.n_shards`
    ranks, rank r keeps shard r's slice of the stacks and the combines
    finish across ranks; with `group=None` they fold the S local shards."""
    if group is not None:
        rank, world = torch.distributed.get_rank(group), torch.distributed.get_world_size(group)
        if world != index.n_shards:
            raise ValueError(f"{world} ranks for an index of {index.n_shards} shards")

        def mine(a):
            return None if a is None else a[rank : rank + 1]

        index = index._replace(
            data=mine(index.data),
            graphs=mine(index.graphs),
            row0s=mine(index.row0s),
            valids=mine(index.valids),
            rescores=mine(index.rescores),
            vwords=mine(index.vwords),
            ids_maps=mine(index.ids_maps),
        )
    s_l, n_loc = index.n_shards, index.n_loc
    row0s = [int(r) for r in index.row0s.tolist()]
    n_owns = [min(n_loc, index.n - row0) for row0 in row0s]
    filtered = fwords is not None
    shards = [index.data[s] for s in range(s_l)]
    if index.scale is not None:
        shards = [VS.VectorStore(d, index.scale, index.offset) for d in shards]
    # B3 sees local rows, so it probes this empty table; freshness against
    # the visited set is taken on global ids
    empty = torch.full((queries.shape[0], 1), -1, dtype=torch.int32, device=queries.device)

    def fetch(sel_id):
        parts = []
        for s in range(s_l):
            owned, loc = _owner(sel_id, row0s[s], n_owns[s], n_loc)
            parts.append(torch.where(owned[:, None], index.graphs[s][loc], -1))
        return _cmax_i32(parts, group)

    def expand(nbrs, lookup):
        outs = []
        for s in range(s_l):
            owned, loc = _owner(nbrs, row0s[s], n_owns[s], n_loc)
            nloc = torch.where(owned, loc, -1).to(torch.int32)
            valid = None if index.valids is None else index.valids[s]
            words = index.vwords[s] if filtered else None
            outs.append(ops.search_expand(shards[s], queries, nloc, empty, valid, words, fwords))
        dq = _cmin([o[1] for o in outs], group)
        ok = _cor([o[2] for o in outs], group)
        nbrs = torch.where(ok, nbrs, -1)
        allowed = (_cor([o[3] for o in outs], group),) if filtered else ()
        return (nbrs, dq, ok & ~_table_member(lookup, nbrs), *allowed)

    out_ids, out_dists, n_exp = _traverse(
        queries,
        index.entry,
        index.entry_row,
        index.entry_valid,
        index.entry_words,
        fwords,
        n=index.n,
        fetch=fetch,
        expand=expand,
        ef=ef,
        max_steps=max_steps,
        visited=visited,
        cap=visited_cap,
    )
    if index.rescores is not None:
        # the cross-shard top-k: each shard re-ranks the final ef candidates
        # it owns against its fp32 slice (+inf elsewhere), and the merge
        # primitive re-sorts, as the replicated `_rescore_merge` does
        d_parts = []
        for s in range(s_l):
            owned, loc = _owner(out_ids, row0s[s], n_owns[s], n_loc)
            diff = queries[:, None, :] - index.rescores[s][loc]
            d_parts.append(torch.where(owned, (diff * diff).sum(-1), torch.inf))
        out_ids, out_dists = ops.topr_merge(out_ids, _cmin(d_parts, group), ef)

    out_ids, out_dists = out_ids[:, :k].contiguous(), out_dists[:, :k].contiguous()
    if index.ids_maps is not None:
        # the owner's slice of the layout pass's inverse permutation
        parts = []
        for s in range(s_l):
            owned, loc = _owner(out_ids, row0s[s], n_owns[s], n_loc)
            parts.append(torch.where(owned, index.ids_maps[s][loc], -1))
        out_ids = torch.where(out_ids >= 0, _cmax_i32(parts, group), -1)
    return SearchResult(out_ids, out_dists, n_exp)


def sharded_search(
    index: CorpusShardedIndex,
    queries,
    *,
    k: int = 10,
    ef: int = 64,
    max_steps: int = 512,
    visited: str = "dense",
    visited_cap: int | None = None,
    filter=None,
    overfetch: int = 4,
    group=None,
) -> SearchResult:
    """Corpus-sharded beam search, bitwise `core.search.search` over the
    unsharded operands for any shard count.

    With `group=None` the S shards' kernel calls run in this process. With
    a `torch.distributed` process group of `index.n_shards` ranks
    (`torch.distributed.group.WORLD` for the default group) rank r runs
    shard r and the combines are collectives; every rank gets the result.
    `filter` is a per-query predicate in any `core.labels.query_words` form;
    the index must have been sharded with `labels=`.
    """
    dev = index.graphs.device
    queries = _device.put(queries, torch.float32, dev)
    fwords, ef, cap = _search_args(
        k, ef, visited, visited_cap, filter, index.vwords, overfetch, dev
    )
    host = VS.is_host(index.rescores)
    # host tier: traverse without the rescore and ids_map operands and keep
    # the whole beam; its global ids drive the host gather, then the
    # replicated path's `_rescore_merge` re-ranks (the flattened ids_map
    # stack is indexed by global id)
    run_idx = index._replace(rescores=None, ids_maps=None) if host else index
    res = run_sharded(
        run_idx,
        queries,
        fwords,
        k=ef if host else k,
        ef=ef,
        max_steps=max_steps,
        visited=visited,
        visited_cap=cap,
        group=group,
    )
    if not host:
        return res
    rv = index.rescores.gather(res.ids)
    flat_map = None if index.ids_maps is None else index.ids_maps.reshape(-1)
    out_ids, out_dists = _rescore_merge(res.ids, rv, queries, flat_map, k)
    return SearchResult(out_ids, out_dists, res.n_expanded)


# ---------------------------------------------------------------------------
# the sharded build: per-partition GRNND, then cross-boundary merge-refine
# ---------------------------------------------------------------------------


def _cross_candidates(raw: torch.Tensor, n: int, n_loc: int) -> torch.Tensor:
    """(N, c) global ids from other shards for every vertex: the raw draws
    r in [0, 2^31 - 1) taken mod the size of the rest of the corpus and
    wrapped around the owner's range (int32 in the reference; exact here
    in int64 for any n below 2^30)."""
    rows = torch.arange(n, dtype=torch.int64, device=raw.device)
    row0 = (rows // n_loc) * n_loc
    n_own = (n - row0).clamp_max(n_loc)
    span = (n - n_own).clamp_min(1)
    cand = ((row0 + n_own)[:, None] + raw.long() % span[:, None]) % n
    return cand.to(torch.int32)


def sharded_build(
    x,
    cfg: GRNNDConfig,
    n_shards: int,
    *,
    merge_rounds: int = 3,
    cross_candidates: int = 8,
    draws=None,
    device="cuda",
) -> P.Pool:
    """Divide-and-conquer build: per-partition GRNND subgraphs, then
    `merge_rounds` cross-boundary merge-refine rounds.

    Each partition builds on its own rows (`draws.partition(s)`); local ids
    are re-based to global and stacked into a block-diagonal pool. Each
    merge round injects `cross_candidates` random other-shard candidates a
    vertex with their true traversal-space distances (`gather_sqdist`),
    both directions, through the order-free request staging; then one
    localized propagation round over every vertex (`draws.merge_pairs`),
    and a reverse-edge pass between rounds. `n_shards=1` is `build_graph`
    with the same draws. Returns the global (N, R) pool on `device`.
    """
    from repro_torch.core.dynamic import _localized_round

    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dev = _device.resolve(device)
    x = VS.to_device(x, dev)
    draws = draws if draws is not None else Draws(0, dev)
    if n_shards == 1:
        return build_graph(x, cfg, draws=draws, device=dev)
    xd, xs, xo = VS.parts(x)
    n = VS.nrows(x)
    row0s, n_loc = shard_bounds(n, n_shards)
    if n_loc <= cfg.s:
        raise ValueError(f"shard size {n_loc} too small for s={cfg.s} init sampling")

    ids_parts, d_parts = [], []
    for s, row0 in enumerate(row0s):
        m = min(n_loc, n - row0)
        rows = xd[row0 : row0 + m]
        x_s = rows if xs is None else VS.VectorStore(rows, xs, xo)
        p = build_graph(x_s, cfg, draws=draws.partition(s), device=dev)
        ids_parts.append(torch.where(p.ids >= 0, p.ids + row0, -1))
        d_parts.append(p.dists)
    pool = P.Pool(torch.cat(ids_parts), torch.cat(d_parts))

    frontier = torch.arange(n, dtype=torch.int32, device=dev)
    owners = frontier.repeat_interleave(cross_candidates)
    for t in range(merge_rounds):
        raw = draws.cross_raw(t, n, cross_candidates).to(dev)
        cand = _cross_candidates(raw, n, n_loc).reshape(-1)
        d = ops.gather_sqdist(x, owners, cand)
        req = P.Requests(
            dst=torch.cat([owners, cand]),
            src=torch.cat([cand, owners]),
            dist=torch.cat([d, d]),
        )
        pool = P.insert_requests(pool, req, cap=cfg.cap)
        si, sj = draws.merge_pairs(t, n, cfg.r, cfg.pairs_per_vertex)
        si = si.to(device=dev, dtype=torch.int32).contiguous()
        sj = sj.to(device=dev, dtype=torch.int32).contiguous()
        pool = _localized_round(x, pool, frontier, si, sj, cfg.cap)
        if t != merge_rounds - 1:
            pool = reverse_edge_round(pool, cfg)
    return pool


# ---------------------------------------------------------------------------
# memory accounting
# ---------------------------------------------------------------------------


def _nbytes(a) -> int:
    return 0 if a is None else int(a.numel()) * a.element_size()


def memory_report(index: CorpusShardedIndex) -> dict:
    """Bytes of O(N) index state per shard against replicated per device.

    `per_shard_bytes` is what one device holds under corpus sharding (its
    slice of every O(N) operand plus the small replicated entry state);
    `replicated_bytes` what the query-sharded layout puts on every device.
    Per-query search state is excluded. A host rescore tier holds no card
    bytes; its size is `rescore_host_bytes`.
    """
    host = VS.is_host(index.rescores)
    resc_dev = None if host else index.rescores
    sliced = (index.data, index.graphs, index.valids, resc_dev, index.vwords, index.ids_maps)
    per_slice = sum(_nbytes(a) // index.n_shards for a in sliced)
    rep_small = _nbytes(index.scale) + _nbytes(index.offset) + _nbytes(index.entry_row)
    frac = index.n / float(index.n_shards * index.n_loc)
    replicated = int(sum(_nbytes(a) for a in sliced) * frac) + rep_small
    return {
        "n": index.n,
        "n_shards": index.n_shards,
        "n_loc": index.n_loc,
        "per_shard_bytes": per_slice + rep_small,
        "replicated_bytes": replicated,
        "rescore_device_bytes": _nbytes(resc_dev) // index.n_shards,
        "rescore_host_bytes": index.rescores.host_bytes() if host else 0,
    }
