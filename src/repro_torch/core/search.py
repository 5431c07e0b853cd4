"""Batched best-first beam search over a GRNND graph.

The fixed search the paper scores every index with, as in the JAX package's
`core/search.py`: a candidate list of `ef` entries per query; each step
expands every query's closest unexpanded candidate and merges its unvisited
neighbors; a query stops when its whole list is expanded.

  * The expansion step (neighbor gather, query distances, visited probe) is
    one kernel, `ops.search_expand`; the beam merge is `ops.topr_merge`.
  * `visited="dense"` keeps an exact (Q, N) mask; `visited="hashed"` a
    per-query open-addressed table of `visited_cap` int32 slots, O(Q·H)
    memory independent of N. Capacity misses only cause re-expansions;
    with `visited_cap >= N` the table is collision-free and the search
    equals the dense one.
  * The JAX `while_loop` becomes a Python loop that asks the card whether
    any query still has a frontier: one host sync per step.
  * The dataset may be a `core.vecstore.VectorStore` (bf16 / int8 rows,
    dequantized inside `search_expand`); `rescore=` re-ranks the final ef
    candidates against fp32 rows, the two-tier layout of the dynamic
    index.
  * `valid=` is the dynamic index's tombstone mask: a dead vertex is never
    expanded, scored or returned.
  * Not ported yet: `labels` / `filter` (ROADMAP queue A.8) and `ids_map`
    (the layout pass, A.9).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import device as _device
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


def default_visited_cap(ef: int) -> int:
    """Default hashed-table size: 8·ef slots (at least 256), independent of N.

    Each expansion inserts at most R fresh ids and the beam retires after
    ~ef expansions, so the load factor stays low and capacity misses rare.
    """
    return max(256, 8 * ef)


def _table_insert(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Insert (Q, R) ids into the (Q, H) open-addressed tables, in place.

    Sequential over the R columns, vectorized over queries, so no two
    inserts race for one empty slot. An id whose probe window holds neither
    itself nor an empty slot is dropped (a capacity miss). ids < 0 are
    skipped. Returns `table`.
    """
    h = table.shape[1]
    for rr in range(ids.shape[1]):
        v = ids[:, rr]
        pos = visited_probe_positions(v, h).long()  # (Q, PL)
        vals = table.gather(1, pos)
        found = (vals == v[:, None]).any(-1)
        empty = vals == -1
        ins = pos.gather(1, empty.to(torch.uint8).argmax(-1, keepdim=True))  # first empty
        do = (v >= 0) & ~found & empty.any(-1)
        cur = table.gather(1, ins)[:, 0]
        table.scatter_(1, ins, torch.where(do, v, cur)[:, None])
    return table


def _table_member(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Membership of (Q, R) ids in the (Q, H) tables: the kernel's probe."""
    q, r = ids.shape
    pos = visited_probe_positions(ids, table.shape[1]).reshape(q, -1).long()
    return (table.gather(1, pos).reshape(q, r, -1) == ids[..., None]).any(-1)


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
    re-rank the final ef candidates with exact distances.
    """
    for name, value, item in (
        ("labels", labels, "A.8"),
        ("filter", filter, "A.8"),
        ("ids_map", ids_map, "A.9"),
    ):
        if value is not None:
            raise NotImplementedError(
                f"search({name}=...) is not ported yet (ROADMAP queue {item})"
            )
    if ef < k:
        raise ValueError(f"ef={ef} must be at least k={k}")
    if visited not in ("dense", "hashed"):
        raise ValueError(f"visited must be 'dense' or 'hashed', got {visited!r}")
    if visited_cap is not None and visited_cap <= 0:
        raise ValueError(f"visited_cap must be positive, got {visited_cap}")

    dev = _device.resolve(device)
    x = VS.to_device(x, dev)
    graph_ids = _device.put(graph_ids, torch.int32, dev)
    queries = _device.put(queries, torch.float32, dev)
    if valid is not None:
        valid = _device.put(valid, torch.bool, dev)
    if rescore is not None:
        rescore = VS.to_device(rescore, dev)
    entry = medoid(x, valid) if entry is None else _device.put(entry, torch.int32, dev)
    n = VS.nrows(x)
    q = queries.shape[0]
    qrows = torch.arange(q, device=dev)

    d_entry = ops.rowwise_sqdist(queries, VS.take(x, entry).expand(q, -1).contiguous())
    if valid is not None:
        # a dead entry contributes nothing; every later insertion into the
        # beam is validity-filtered inside search_expand
        d_entry = torch.where(valid[entry.long()], d_entry, torch.inf)
    cand_ids = torch.full((q, ef), -1, dtype=torch.int32, device=dev)
    cand_ids[:, 0] = entry
    cand_dists = torch.full((q, ef), torch.inf, dtype=torch.float32, device=dev)
    cand_dists[:, 0] = d_entry
    expanded = torch.zeros((q, ef), dtype=torch.bool, device=dev)
    n_exp = torch.zeros((q,), dtype=torch.int32, device=dev)

    if visited == "dense":
        vstate = torch.zeros((q, n), dtype=torch.uint8, device=dev)
        vstate[:, entry.long()] = 1
        # an empty 1-slot table makes the kernel's probe a no-op
        lookup = torch.full((q, 1), -1, dtype=torch.int32, device=dev)
    else:
        cap = visited_cap if visited_cap is not None else default_visited_cap(ef)
        vstate = torch.full((q, cap), -1, dtype=torch.int32, device=dev)
        _table_insert(vstate, entry.expand(q, 1))
        lookup = vstate

    for _ in range(max_steps):
        frontier = (cand_ids >= 0) & ~expanded
        if not bool(frontier.any()):  # the one host sync per step
            break
        frontier_d = torch.where(frontier, cand_dists, torch.inf)
        sel = frontier_d.argmin(-1)  # (Q,)
        active = torch.isfinite(frontier_d.gather(1, sel[:, None])[:, 0])
        sel_id = cand_ids[qrows, sel]
        expanded[qrows, sel] = True

        nbrs = graph_ids[sel_id.clamp_min(0).long()]  # (Q, R)
        nbrs = torch.where(active[:, None] & (nbrs >= 0), nbrs, -1)
        nbrs, dq, fresh = ops.search_expand(x, queries, nbrs, lookup, valid)
        if visited == "dense":
            idx = nbrs.clamp_min(0).long()
            fresh = fresh & ~vstate.gather(1, idx).bool()
            vstate.scatter_reduce_(1, idx, fresh.to(torch.uint8), reduce="amax")
        else:
            _table_insert(vstate, torch.where(fresh, nbrs, -1))

        dq = torch.where(fresh, dq, torch.inf)
        n_exp += fresh.sum(-1, dtype=torch.int32)

        # keep the ef best of (candidates ∪ fresh neighbors); candidates come
        # first, so a re-entering duplicate keeps its original beam slot
        all_ids = torch.cat([cand_ids, torch.where(fresh, nbrs, -1)], dim=-1)
        all_d = torch.cat([cand_dists, dq], dim=-1)
        new_ids, new_d = ops.topr_merge(all_ids, all_d, ef)

        # an entry is expanded iff its id matches an expanded candidate
        # (the -2 sentinel keeps empty slots from matching each other)
        exp_src = torch.where(expanded & (cand_ids >= 0), cand_ids, -2)
        expanded = (new_ids[:, :, None] == exp_src[:, None, :]).any(-1) | (new_ids < 0)
        cand_ids, cand_dists = new_ids, new_d

    if rescore is not None:
        # re-rank the final ef candidates with exact distances against the
        # rescore tier: one (Q, ef, D) gather, pads masked by id, then the
        # merge primitive (ids are already unique, so a pure re-sort)
        rv = VS.take(rescore, cand_ids.clamp_min(0))  # (Q, ef, D)
        diff = queries[:, None, :] - rv
        d_exact = torch.where(cand_ids >= 0, (diff * diff).sum(-1), torch.inf)
        cand_ids, cand_dists = ops.topr_merge(cand_ids, d_exact, ef)

    return SearchResult(cand_ids[:, :k], cand_dists[:, :k], n_exp)
