"""The vertex-sharded build and the sharded searches on `torch.distributed`.

A port of the JAX package's `core/distributed.py`. Where the reference takes
a device mesh and axis names, these functions take `group`: a
`torch.distributed` process group, None meaning the default group. The
shard index is the rank in that group. Callers pass the same global
operands on every rank and get the same global result back on every rank;
a rank's own work covers only its slice, and `all_gather` or
`all_to_all_single` assembles the outputs.

  * The build (`sharded_build_graph`, `make_sharded_builder`): vectors are
    replicated, pools sharded over vertices (N divisible by the world
    size). Each rank makes the redirect requests of its own vertices; they
    are exchanged by an all-gather of the (dst, src, dist) triples
    (`comm="allgather"`, exact) or bucketed per destination rank with a
    fixed capacity and `all_to_all_single` (`comm="a2a"`, requests past a
    bucket's capacity dropped, as the reference drops them). Survivors
    never leave their rank. The merge is the order-free staging of the
    single-process build, so the pool is bitwise `grnnd.build_graph`'s
    when that is fed the ranks' draws concatenated.
  * `distributed_search` shards the queries: x and the graph replicated,
    each rank searching its slice with `core.search.search`; bitwise the
    single-process search for any world size.
  * `corpus_sharded_search` shards the corpus: rank r runs shard r of a
    `corpus_shard.CorpusShardedIndex`, the owner-combines as `all_reduce`
    MIN / MAX; bitwise the single-process search too.
  * `sharded_apply_requests` routes an insertion batch to the owning ranks
    (the dynamic index's mutation path under `DynamicIndex(group=)`).

One card takes one NCCL rank, so on a single card these run at world size
1 on NCCL; more ranks run on gloo on the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch.core import corpus_shard as CS
from repro_torch.core import labels as L
from repro_torch.core import pools as P
from repro_torch.core import vecstore as VS
from repro_torch.core.draws import Draws
from repro_torch.core.grnnd import (
    GRNNDConfig,
    _pair_requests_chunk,
    _reverse_requests,
    _sorted_requests_chunk,
    check_order,
)
from repro_torch.core.search import SearchResult, _rescore_merge, medoid, search
from repro_torch.kernels import ops

COMMS = ("allgather", "a2a")


def _rank_world(group) -> tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' equal-shaped `t` concatenated along dim 0, in rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.cat(out)


def _gather_requests(req: P.Requests, group) -> P.Requests:
    return P.Requests(*(_all_gather(a, group) for a in req))


def _vertex_slice(n: int, group) -> tuple[int, int, int, int]:
    """(rank, world, row0, n_loc) of this rank's vertex slice."""
    rank, world = _rank_world(group)
    if n % world:
        raise ValueError(f"{n} vertices do not split evenly over {world} ranks")
    n_loc = n // world
    return rank, world, rank * n_loc, n_loc


# ---------------------------------------------------------------------------
# the vertex-sharded build
# ---------------------------------------------------------------------------


def _local_round_requests(x, ids_loc, dists_loc, draws, cfg: GRNNDConfig, t1, t2, rank):
    """The redirect requests and kill mask of one rank's vertex slice."""
    n_loc, r = ids_loc.shape
    if cfg.order != "disordered":
        return _sorted_requests_chunk(x, ids_loc, dists_loc, cfg)
    si, sj = draws.shard_slot_pairs(t1, t2, rank, n_loc, r, cfg.pairs_per_vertex)
    dev = ids_loc.device
    si = si.to(device=dev, dtype=torch.int32).contiguous()
    sj = sj.to(device=dev, dtype=torch.int32).contiguous()
    return _pair_requests_chunk(x, ids_loc, dists_loc, si, sj)


def _filter_to_local(req: P.Requests, row0: int, n_loc: int) -> P.Requests:
    """Re-base request destinations to local rows and drop the others.

    Self-inserts are dropped here, while dst and src are both global ids;
    after re-basing, dst is local and src global, so the staging that
    follows must run with drop_self=False.
    """
    dst_local = req.dst - row0
    ok = (req.dst >= 0) & (dst_local >= 0) & (dst_local < n_loc) & (req.dst != req.src)
    return P.Requests(dst=torch.where(ok, dst_local, -1), src=req.src, dist=req.dist)


def _merge_local(ids_loc, dists_loc, local: P.Requests, cap: int):
    """Stage a rank's re-based requests and merge them into its rows."""
    n_loc, r = ids_loc.shape
    staged_i, staged_d = P.group_requests(local, n_loc, cap, drop_self=False)
    return ops.topr_merge(
        torch.cat([ids_loc, staged_i], dim=-1), torch.cat([dists_loc, staged_d], dim=-1), r
    )


def _a2a_exchange(req: P.Requests, n_loc: int, cap: int, group):
    """Bucket requests by destination rank, at most `cap` a bucket in
    request order (the rest dropped), and swap buckets with every rank:
    (requests received, requests this rank dropped)."""
    world = dist.get_world_size(group)
    dev = req.dst.device
    dst_rank = torch.where(req.dst >= 0, req.dst // n_loc, world)
    order = torch.argsort(dst_rank, stable=True)
    ds = dst_rank[order]
    starts = torch.searchsorted(ds, torch.arange(world + 1, dtype=ds.dtype, device=dev))
    rank_in = torch.arange(ds.shape[0], device=dev) - starts[ds]
    keep = (rank_in < cap) & (ds < world)
    flat = torch.where(keep, ds * cap + rank_in, world * cap)
    out = []
    for a, fill in ((req.dst, -1), (req.src, -1), (req.dist, torch.inf)):
        bucket = torch.full((world * cap + 1,), fill, dtype=a.dtype, device=dev)
        bucket.scatter_(0, flat, a[order])
        got = torch.empty(world * cap, dtype=a.dtype, device=dev)
        dist.all_to_all_single(got, bucket[:-1].contiguous(), group=group)
        out.append(got)
    dropped = int(((~keep) & (ds < world)).sum())
    return P.Requests(*out), dropped


def _round_local(
    x, ids_loc, dists_loc, draws, t1: int, t2: int, cfg: GRNNDConfig, group, comm: str
):
    """One build round over this rank's vertex slice: (ids, dists) of the
    slice after the round, and the requests dropped at the a2a buckets'
    capacity (summed over ranks; 0 under allgather)."""
    n_loc, r = ids_loc.shape
    rank, world = _rank_world(group)
    row0 = rank * n_loc
    redirect, killed = _local_round_requests(x, ids_loc, dists_loc, draws, cfg, t1, t2, rank)
    dropped = 0
    if comm == "allgather":
        red_all = _gather_requests(redirect, group)
    else:
        cap = max(2 * n_loc * cfg.pairs_per_vertex // max(world, 1), r)
        red_all, lost = _a2a_exchange(redirect, n_loc, cap, group)
        lost_t = torch.tensor([lost], dtype=torch.int64, device=ids_loc.device)
        dist.all_reduce(lost_t, group=group)
        dropped = int(lost_t[0])
    # survivors stay aligned on their rank; only redirects travel
    surv_ids = torch.where(killed, -1, ids_loc)
    surv_dists = torch.where(killed, torch.inf, dists_loc)
    local = _filter_to_local(red_all, row0, n_loc)
    return (*_merge_local(surv_ids, surv_dists, local, cfg.cap), dropped)


def _check_comm(comm: str) -> None:
    if comm not in COMMS:
        raise ValueError(f"comm must be one of {COMMS}, got {comm!r}")


def make_sharded_builder(cfg: GRNNDConfig, group=None, comm: str = "allgather"):
    """One vertex-sharded build round: `build_round(x, pool, draws, t1, t2)`
    takes the global pool on every rank and returns the global pool after
    round (t1, t2). `comm` is "allgather" (exact) or "a2a" (buckets of
    max(2 · n_loc · pairs / world, R) requests a rank pair, the rest
    dropped)."""
    _check_comm(comm)

    def build_round(x, pool: P.Pool, draws, t1: int = 0, t2: int = 0) -> P.Pool:
        _, _, row0, n_loc = _vertex_slice(pool.n, group)
        ids, dists, _ = _round_local(
            x, pool.ids[row0 : row0 + n_loc], pool.dists[row0 : row0 + n_loc], draws, t1, t2,
            cfg, group, comm,
        )
        return P.Pool(_all_gather(ids, group), _all_gather(dists, group))

    return build_round


def _sharded_reverse(ids_loc, dists_loc, cfg: GRNNDConfig, group):
    """Reverse-edge sampling across ranks (all-gather exchange): a rank's
    local (ids, dists) after the round."""
    n_loc = ids_loc.shape[0]
    row0 = _rank_world(group)[0] * n_loc
    req_all = _gather_requests(_reverse_requests(ids_loc, dists_loc, cfg.rho, row0), group)
    return _merge_local(ids_loc, dists_loc, _filter_to_local(req_all, row0, n_loc), cfg.cap)


def sharded_build_graph(
    x,
    cfg: GRNNDConfig,
    *,
    group=None,
    comm: str = "allgather",
    draws=None,
    device="cuda",
    stats: dict | None = None,
) -> P.Pool:
    """The whole vertex-sharded build: the random init (replicated math),
    then T1 x (T2 sharded rounds + sharded reverse sampling), the pool
    sharded over the group's ranks between rounds. Returns the global pool
    on every rank. Rank r's slot pairs of round (t1, t2) come from
    `draws.shard_slot_pairs(t1, t2, r, ...)`. With `stats`,
    `stats["a2a_dropped"]` receives the requests dropped at the a2a
    buckets' capacity."""
    check_order(cfg)
    dev = _device.resolve(device)
    x = VS.to_device(x, dev)
    draws = draws if draws is not None else Draws(0, dev)
    _, _, row0, n_loc = _vertex_slice(VS.nrows(x), group)
    pool = P.init_random(draws, x, cfg.s, cfg.r)
    ids = pool.ids[row0 : row0 + n_loc].contiguous()
    dists = pool.dists[row0 : row0 + n_loc].contiguous()
    _check_comm(comm)
    dropped = 0
    for t1 in range(cfg.t1):
        for t2 in range(cfg.t2):
            ids, dists, lost = _round_local(x, ids, dists, draws, t1, t2, cfg, group, comm)
            dropped += lost
        if t1 != cfg.t1 - 1:
            ids, dists = _sharded_reverse(ids, dists, cfg, group)
    if stats is not None:
        stats["a2a_dropped"] = dropped
    return P.Pool(_all_gather(ids, group), _all_gather(dists, group))


# ---------------------------------------------------------------------------
# the sharded searches
# ---------------------------------------------------------------------------


def distributed_search(
    x,
    graph_ids,
    queries,
    *,
    group=None,
    k: int = 10,
    ef: int = 64,
    max_steps: int = 512,
    entry=None,
    visited: str = "dense",
    visited_cap: int | None = None,
    valid=None,
    rescore=None,
    labels=None,
    filter=None,
    ids_map=None,
    device="cuda",
) -> SearchResult:
    """Query-sharded beam search over the group's ranks.

    x and the graph are replicated; the queries (padded to a multiple of
    the world size with copies of the first) and their predicate words are
    split by rank, each rank runs `core.search.search` on its slice, and
    the results are all-gathered, so every rank gets the single-process
    search's result bitwise. The arguments are `search`'s. A
    `vecstore.HostTier` rescore stays off the ranks: they traverse without
    it (the whole beam, ids_map deferred) and the gathered ids are
    re-ranked on the host tier by `_rescore_merge`, as `search` does.
    """
    dev = _device.resolve(device)
    rank, world = _rank_world(group)
    x = VS.to_device(x, dev)
    graph_ids = _device.put(graph_ids, torch.int32, dev)
    queries = _device.put(queries, torch.float32, dev)
    if valid is not None:
        valid = _device.put(valid, torch.bool, dev)
    entry = medoid(x, valid) if entry is None else _device.put(entry, torch.int32, dev)
    vwords = fwords = None
    if filter is not None:
        if labels is None:
            raise ValueError("filtered search needs a label store (labels=)")
        vwords = _device.put(L.store_words(labels), torch.int32, dev)
        fwords = _device.put(L.query_words(filter, vwords.shape[1]), torch.int32, dev)

    host = VS.is_host(rescore)
    if host:
        # the inner search's filtered widening (its default overfetch 4)
        # applied here, then k = ef and overfetch 1: the ranks return the
        # whole beam or heap the host re-rank needs
        ef_run = max(ef, 4 * k) if filter is not None else ef
        k_run, of_run = ef_run, 1
    else:
        ef_run, k_run, of_run = ef, k, 4

    qn = queries.shape[0]
    pad = (-qn) % world
    q_all, f_all = queries, fwords
    if pad:
        q_all = torch.cat([queries, queries[:1].expand(pad, -1)])
        if fwords is not None:  # the pad rows' predicates ride along
            f_all = torch.cat([fwords, fwords[:1].expand(pad, -1)])
    q_loc = (qn + pad) // world
    sl = slice(rank * q_loc, (rank + 1) * q_loc)
    res = search(
        x,
        graph_ids,
        q_all[sl],
        k=k_run,
        ef=ef_run,
        max_steps=max_steps,
        entry=entry,
        visited=visited,
        visited_cap=visited_cap,
        valid=valid,
        rescore=None if host else rescore,
        labels=vwords,
        filter=None if f_all is None else f_all[sl],
        overfetch=of_run,
        ids_map=None if host else ids_map,
        device=dev,
    )
    ids, dists, n_exp = (_all_gather(a, group)[:qn] for a in res)
    if not host:
        return SearchResult(ids, dists, n_exp)
    if ids_map is not None:
        ids_map = _device.put(ids_map, torch.int32, dev)
    out_ids, out_dists = _rescore_merge(ids, rescore.gather(ids), queries, ids_map, k)
    return SearchResult(out_ids, out_dists, n_exp)


def corpus_sharded_search(
    index,
    queries,
    *,
    fwords,
    group=None,
    k: int,
    ef: int,
    max_steps: int,
    visited: str,
    visited_cap: int,
) -> SearchResult:
    """Run a `corpus_shard.CorpusShardedIndex` over the group's ranks, rank r
    holding shard r (its slice of the stacks) and the owner-combines run
    as collectives (`corpus_shard.run_sharded`): arguments arrive
    normalized (ef widened, the table size resolved, the filter packed to
    (Q, W) words). The world size must equal `index.n_shards`."""
    group = group if group is not None else dist.group.WORLD
    kw = dict(k=k, ef=ef, max_steps=max_steps, visited=visited, visited_cap=visited_cap)
    return CS.run_sharded(index, queries, fwords, group=group, **kw)


def sharded_apply_requests(
    pool: P.Pool, req: P.Requests, cap: int | None = None, *, group=None
) -> P.Pool:
    """Route a flat insertion batch (global destination ids, the same on
    every rank) to the owning ranks: each keeps the requests of its own
    rows (`_filter_to_local`, as the build rounds) and merges them through
    the staging; the global pool comes back on every rank, bitwise
    `pools.insert_requests(pool, req, cap)`."""
    cap = cap if cap is not None else pool.r
    _, _, row0, n_loc = _vertex_slice(pool.n, group)
    ids, dists = _merge_local(
        pool.ids[row0 : row0 + n_loc],
        pool.dists[row0 : row0 + n_loc],
        _filter_to_local(req, row0, n_loc),
        cap,
    )
    return P.Pool(_all_gather(ids, group), _all_gather(dists, group))
