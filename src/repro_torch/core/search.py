"""Batched best-first beam search over a GRNND graph.

The fixed search the paper scores every index with, as in the JAX package's
`core/search.py`: a candidate list of `ef` entries per query; each step
expands every query's closest unexpanded candidate and merges its unvisited
neighbors; a query stops when its whole list is expanded.

  * The expansion step (neighbor gather, query distances, visited probe) is
    one kernel, `ops.search_expand`; the beam merge is `ops.topr_merge`.
  * `_traverse` is the one beam loop of the package. Its caller supplies
    the entry and the two steps that read O(N) state: the fetch of the
    selected vertices' graph rows and the expansion. `search` gathers them
    from the replicated operands; `corpus_shard.sharded_search` from the
    shards, combined by owner.
  * `visited="dense"` keeps an exact (Q, N) mask; `visited="hashed"` a
    per-query open-addressed table of `visited_cap` int32 slots, O(Q·H)
    memory independent of N. Capacity misses only cause re-expansions;
    with `visited_cap >= N` the table is collision-free and the search
    equals the dense one.
  * The JAX `while_loop` becomes a Python loop that reads each frontier
    test (does any query still have a frontier?) one iteration late: the
    test is copied to a pinned host slot behind an event, and the host
    waits for the previous iteration's event alone, so the card always
    holds a queued step while the host launches the next. The loop so runs
    one spare step past the first empty frontier, a no-op tallied as
    `search/spare_steps`; the step count depends on the inputs only. Each
    iteration is a `search.step` span (`repro_torch.trace`); the counted
    host waits (`trace.SYNCS`) are the frontier's event wait, once an
    iteration, and the entry's gather, once a call, the one wait that
    drains the stream.
  * The dataset may be a `core.vecstore.VectorStore` (bf16 / int8 rows,
    dequantized inside `search_expand`); `rescore=` re-ranks the final ef
    candidates against fp32 rows, the two-tier layout of the dynamic
    index.
  * `valid=` is the dynamic index's tombstone mask: a dead vertex is never
    expanded, scored or returned.
  * Filtered search (`labels=`, `filter=`, `core/labels.py`) evaluates the
    per-query label predicate inside the same expansion kernel and keeps a
    separate result heap of the vertices that pass; the beam itself stays
    unfiltered (route-through), so the walk crosses filtered-out regions.
  * `rescore=` may be a `vecstore.HostTier`: traversal runs on the card
    without it, the final ef candidates' rows are gathered on the host,
    and `_rescore_merge` re-ranks them with the device tier's formula, so
    the two placements give bitwise-equal results.
  * `ids_map=` is the layout pass's inverse permutation (`core/layout.py`):
    one gather after the k-slice and the re-rank turns internal rows back
    into the caller's ids.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch import trace
from repro_torch.core import labels as L
from repro_torch.core import vecstore as VS
from repro_torch.kernels import ops
from repro_torch.kernels.ref import visited_probe_positions

EF_CEILING = 512  # past this, O(ef²) beam maintenance dominates


class SearchResult(NamedTuple):
    ids: torch.Tensor  # (Q, k) int32
    dists: torch.Tensor  # (Q, k) float32
    n_expanded: torch.Tensor  # (Q,) int32, distance computations proxy


def medoid(x, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Entry point: the vertex nearest to the dataset centroid (int32 scalar).

    With a `valid` mask the centroid and the argmin are taken over live rows
    only. A store's centroid is that of its dequantized rows, and the
    distances are read through the kernel's fused dequant.
    """
    if valid is None:
        c = VS.dequant(x).mean(0, keepdim=True)
        return ops.pairwise_sqdist(c, x)[0].argmin().to(torch.int32)
    v = valid.float()
    c = ((VS.dequant(x) * v[:, None]).sum(0) / v.sum().clamp_min(1.0))[None, :]
    d = torch.where(valid, ops.pairwise_sqdist(c, x)[0], torch.inf)
    return d.argmin().to(torch.int32)


def overfetch_ef(n: int, k: int, selectivity: float, ef: int) -> int:
    """The low-selectivity over-fetch policy of filtered search: widen the
    beam toward ~4·k/selectivity so ~k allowed survivors exist, clamped at
    the corpus size and at EF_CEILING (past it the per-step merge's O(ef²)
    work costs more than the recall it buys)."""
    return max(ef, min(n, math.ceil(4 * k / selectivity), EF_CEILING))


def default_visited_cap(ef: int) -> int:
    """Default hashed-table size: 8·ef slots (at least 256), independent of N.

    Each expansion inserts at most R fresh ids and the beam retires after
    ~ef expansions, so the load factor stays low and capacity misses rare.
    """
    return max(256, 8 * ef)


def _table_insert(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Insert (Q, R) ids into the (Q, H) open-addressed tables, in place, in
    column order (`ops.visited_insert`: one launch on the card). An id whose
    probe window holds neither itself nor an empty slot is dropped (a
    capacity miss). ids < 0 are skipped. Returns `table`.
    """
    return ops.visited_insert(table, ids.contiguous())


def _table_member(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Membership of (Q, R) ids in the (Q, H) tables: the kernel's probe."""
    q, r = ids.shape
    pos = visited_probe_positions(ids, table.shape[1]).reshape(q, -1).long()
    return (table.gather(1, pos).reshape(q, r, -1) == ids[..., None]).any(-1)


def _rescore_merge(out_ids, rv, queries, ids_map, k: int):
    """The re-rank tail of a search with a rescore tier: exact fp32
    distances of the (Q, ef) candidates against their gathered rows `rv`,
    pads masked to +inf by id (so a pad row's content is irrelevant), the
    merge primitive as a pure re-sort, the k-slice, then `ids_map`. The
    device and host tiers both run it, so their results are bitwise equal."""
    diff = queries[:, None, :] - rv
    d_exact = torch.where(out_ids >= 0, (diff * diff).sum(-1), torch.inf)
    out_ids, out_dists = ops.topr_merge(out_ids, d_exact, out_ids.shape[1])
    return _map_ids(out_ids[:, :k], ids_map), out_dists[:, :k]


def _map_ids(ids, ids_map):
    """Internal rows -> the caller's ids through the layout's inverse
    permutation (None: ids as they are)."""
    if ids_map is None:
        return ids
    return torch.where(ids >= 0, ids_map[ids.clamp_min(0).long()], -1)


def _search_args(k, ef, visited, visited_cap, filter, vwords, overfetch, dev):
    """The argument rules both searches share: (filter words or None, the
    working ef, the hashed table's size or 0 for the dense set). `vwords`
    are the corpus's label words, or None without labels."""
    if ef < k:
        raise ValueError(f"ef={ef} must be at least k={k}")
    if visited not in ("dense", "hashed"):
        raise ValueError(f"visited must be 'dense' or 'hashed', got {visited!r}")
    if visited_cap is not None and visited_cap <= 0:
        raise ValueError(f"visited_cap must be positive, got {visited_cap}")
    fwords = None
    if filter is not None:
        if vwords is None:
            raise ValueError("filtered search needs a label store (labels=)")
        fwords = _device.put(L.query_words(filter, vwords.shape[-1]), torch.int32, dev)
        ef = max(ef, overfetch * k)
    cap = 0
    if visited == "hashed":
        cap = visited_cap if visited_cap is not None else default_visited_cap(ef)
    return fwords, ef, cap


class _LateTest:
    """The frontier tests of one beam loop, read by the host one test late.

    `put(t)` copies the 0-dim device bool `t` into a pinned host slot
    (`non_blocking`) and records an event behind the copy; `get(i)` waits
    for the event of the i-th put alone, not for the stream, and reads its
    slot. Two slots, so put i may be queued before put i - 1 is read. On
    the CPU the copy is the read and there is no event.
    """

    def __init__(self, dev):
        cuda = dev.type == "cuda"
        self.slots = [torch.empty((), dtype=torch.bool, pin_memory=cuda) for _ in range(2)]
        self.events = [torch.cuda.Event() for _ in range(2)] if cuda else None
        self.stream = torch.cuda.current_stream(dev) if cuda else None
        self.n = 0

    def put(self, t: torch.Tensor) -> None:
        i = self.n % 2
        self.slots[i].copy_(t, non_blocking=True)
        if self.events is not None:
            self.events[i].record(self.stream)
        self.n += 1

    def get(self, i: int) -> bool:
        """The i-th put's value; i is one of the last two puts."""
        if self.events is not None:
            self.events[i % 2].synchronize()
        return bool(self.slots[i % 2])


def _traverse(
    queries,
    entry,
    entry_row,
    entry_live,
    entry_words,
    fwords,
    *,
    n: int,
    fetch,
    expand,
    ef: int,
    max_steps: int,
    visited: str,
    cap: int,
):
    """The beam loop: (Q, ef) ids and dists of the final beam, or of the
    result heap under a filter, and n_expanded.

    The caller supplies the entry (its id, fp32 row, liveness or None, label
    words or None), the corpus size `n` (for the dense mask) and the two
    steps that read O(N) state: `fetch(sel_id)`, the selected vertices'
    (Q, R) graph rows, and `expand(nbrs, lookup)`, B3's (nbrs, dq, fresh)
    (with `allowed` fourth under a filter), fresh against the visited
    table `lookup`. The beam is replicated, so under a process group every
    rank leaves the loop at the same step.

    Step i runs iff test i - 1 found a frontier (step 0 iff there is a
    query), never past `max_steps`: one step more than a loop that waits
    for each test before its step, and that spare step is a no-op (every
    query selects an +inf slot, so it is inactive; the only flag it sets is
    on a slot already expanded or empty).
    """
    dev = queries.device
    q = queries.shape[0]
    qrows = torch.arange(q, device=dev)
    filtered = fwords is not None

    d_entry = ops.rowwise_sqdist(queries, entry_row.expand(q, -1).contiguous())
    if entry_live is not None:
        # a dead entry contributes nothing; every later insertion into the
        # beam is validity-filtered inside search_expand
        d_entry = torch.where(entry_live, d_entry, torch.inf)
    cand_ids = torch.full((q, ef), -1, dtype=torch.int32, device=dev)
    cand_ids[:, 0] = entry
    cand_dists = torch.full((q, ef), torch.inf, dtype=torch.float32, device=dev)
    cand_dists[:, 0] = d_entry
    expanded = torch.zeros((q, ef), dtype=torch.bool, device=dev)
    n_exp = torch.zeros((q,), dtype=torch.int32, device=dev)

    if filtered:
        # the result heap: the beam keeps every live vertex so the walk can
        # route through filtered-out regions; only this heap, what the caller
        # sees, applies the predicate. It starts with the entry iff the
        # entry passes.
        e_ok = ((entry_words[None, :] & fwords) != 0).any(-1) & torch.isfinite(d_entry)
        res_ids = torch.full((q, ef), -1, dtype=torch.int32, device=dev)
        res_ids[:, 0] = torch.where(e_ok, entry, -1)
        res_dists = torch.full((q, ef), torch.inf, dtype=torch.float32, device=dev)
        res_dists[:, 0] = torch.where(e_ok, d_entry, torch.inf)

    if visited == "dense":
        vstate = torch.zeros((q, n), dtype=torch.uint8, device=dev)
        vstate[:, entry.long()] = 1
        # an empty 1-slot table makes the kernel's probe a no-op
        lookup = torch.full((q, 1), -1, dtype=torch.int32, device=dev)
    else:
        vstate = torch.full((q, cap), -1, dtype=torch.int32, device=dev)
        _table_insert(vstate, entry.expand(q, 1))
        lookup = vstate

    tests = _LateTest(dev)
    steps = 0
    for _ in range(max_steps):
        with trace.span("search.step"):
            with trace.span("search.frontier"):
                frontier = (cand_ids >= 0) & ~expanded
                trace.count("search.frontier")
                tests.put(frontier.any())
                # waits for the previous test alone: the step launched
                # after it stays queued on the card
                more = tests.get(steps - 1) if steps else q > 0
            if not more:
                break
            steps += 1
            with trace.span("search.beam"):
                frontier_d = torch.where(frontier, cand_dists, torch.inf)
                sel = frontier_d.argmin(-1)  # (Q,)
                active = torch.isfinite(frontier_d.gather(1, sel[:, None])[:, 0])
                sel_id = cand_ids[qrows, sel]
                expanded.scatter_(1, sel[:, None], True)

            with trace.span("search.expand"):
                nbrs = fetch(sel_id)  # (Q, R)
                nbrs = torch.where(active[:, None] & (nbrs >= 0), nbrs, -1)
                out = expand(nbrs, lookup)
                nbrs, dq, fresh = out[:3]
            with trace.span("search.visited"):
                if visited == "dense":
                    idx = nbrs.clamp_min(0).long()
                    fresh = fresh & ~vstate.gather(1, idx).bool()
                    vstate.scatter_reduce_(1, idx, fresh.to(torch.uint8), reduce="amax")
                else:
                    _table_insert(vstate, torch.where(fresh, nbrs, -1))

            with trace.span("search.beam"):
                dq = torch.where(fresh, dq, torch.inf)
                n_exp += fresh.sum(-1, dtype=torch.int32)

                # keep the ef best of (candidates ∪ fresh neighbors); candidates
                # come first, so a re-entering duplicate keeps its original beam
                # slot. The beam takes fresh neighbors whatever the predicate says.
                all_ids = torch.cat([cand_ids, torch.where(fresh, nbrs, -1)], dim=-1)
                all_d = torch.cat([cand_dists, dq], dim=-1)
                # each entry keeps the expanded flag of the slot it came from:
                # the candidates' ids are unique, so a surviving fresh neighbor
                # is new to the beam (unexpanded); an empty slot counts as expanded
                cand_ids, cand_dists, expanded = ops.topr_merge(all_ids, all_d, ef, flags=expanded)
                if filtered:
                    # a vertex enters the result heap once, at its fresh sighting,
                    # with its real distance, iff the predicate admits it
                    keep = fresh & out[3]
                    res_ids, res_dists = ops.topr_merge(
                        torch.cat([res_ids, torch.where(keep, nbrs, -1)], dim=-1),
                        torch.cat([res_dists, torch.where(keep, dq, torch.inf)], dim=-1),
                        ef,
                    )

    if steps and not tests.get(steps - 1):
        trace.tally("search/spare_steps")
    if filtered:
        return res_ids, res_dists, n_exp
    return cand_ids, cand_dists, n_exp


def search(
    x,
    graph_ids,
    queries,
    *,
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
    overfetch: int = 4,
    ids_map=None,
    device="cuda",
) -> SearchResult:
    """Search the graph for the k nearest vertices to each query row.

    x (the (N, D) traversal tier: a tensor or a `VectorStore`), graph_ids
    (N, R) int32 and queries (Q, D) are moved to `device` (default "cuda";
    raises without a card). `entry` defaults to the medoid. `visited` is
    "dense" (exact (Q, N) mask) or "hashed" (`visited_cap` slots per query,
    default `default_visited_cap(ef)`). `valid` is an (N,) bool mask of live
    vertices. `rescore` is an (N, D) fp32 tier (or a store) whose rows
    re-rank the final ef candidates with exact distances, or a
    `vecstore.HostTier` holding them on the host.

    `labels` (a `LabelStore` or (N, W) packed words) and `filter` (packed
    (Q, W) words, a (Q, L) bool label mask or (Q,) label ids) select
    filtered search: every returned id satisfies its query's predicate, and
    the working ef is at least `overfetch * k`. `labels` alone is inert.
    `ids_map` is an (N,) int32 map applied to the returned ids last (the
    layout pass's inverse permutation).
    """
    dev = _device.resolve(device)
    x = VS.to_device(x, dev)
    graph_ids = _device.put(graph_ids, torch.int32, dev)
    queries = _device.put(queries, torch.float32, dev)
    if valid is not None:
        valid = _device.put(valid, torch.bool, dev)
    vwords = None
    if filter is not None and labels is not None:
        vwords = _device.put(L.store_words(labels), torch.int32, dev)
    fwords, ef, cap = _search_args(k, ef, visited, visited_cap, filter, vwords, overfetch, dev)
    if ids_map is not None:
        ids_map = _device.put(ids_map, torch.int32, dev)
    host = VS.is_host(rescore)
    if rescore is not None and not host:
        rescore = VS.to_device(rescore, dev)
    entry = medoid(x, valid) if entry is None else _device.put(entry, torch.int32, dev)

    trace.count("search.entry")  # a gather by a 0-dim index reads the index back
    out_ids, out_dists, n_exp = _traverse(
        queries,
        entry,
        VS.take(x, entry),
        None if valid is None else valid[entry.long()],
        None if vwords is None else vwords[entry.long()],
        fwords,
        n=VS.nrows(x),
        fetch=lambda sel_id: graph_ids[sel_id.clamp_min(0).long()],
        expand=lambda nbrs, lookup: ops.search_expand(
            x, queries, nbrs, lookup, valid, vwords, fwords
        ),
        ef=ef,
        max_steps=max_steps,
        visited=visited,
        cap=cap,
    )
    if rescore is None:
        return SearchResult(_map_ids(out_ids[:, :k], ids_map), out_dists[:, :k], n_exp)
    # re-rank the final ef candidates (under a filter: the result heap, which
    # holds allowed ids only) with exact distances: one (Q, ef, D) gather, on
    # the card or, for the host tier, on the host
    if host:
        rv = rescore.gather(out_ids)
    else:
        rv = VS.take(rescore, out_ids.clamp_min(0))
    out_ids, out_dists = _rescore_merge(out_ids, rv, queries, ids_map, k)
    return SearchResult(out_ids, out_dists, n_exp)
