"""Post-build graph layout: packed adjacency, locality renumbering, pruning.

A port of the JAX package's `core/layout.py`. The build leaves (N, R) pools
in the row order propagation left them; three changes of representation
speed the search without changing its algorithm:

  1. **Degree-fixed packed adjacency** — each row's valid ids move to the
     front in rank order (a stable compaction), then rows are padded with
     -1 or cut by rank to one degree D, by default the largest row degree
     (lossless).
  2. **Vertex renumbering for locality** — a permutation puts vertices the
     beam touches together at nearby rows: BFS levels from the medoid, or
     hubs first by in-degree (numpy on the host, as in the reference).
  3. **Detour-count pruning** (optional, `prune=True`) — keep the D edges
     per row with the fewest two-hop detours.

The permutation contract: `perm[old] = new`, `inv[new] = old`. Vectors,
adjacency (rows and the ids in them), the tombstone mask, the rescore tier
and the label words are all permuted together, and `inv` goes to the
search as `ids_map`, so callers see their original ids. The entry is the
medoid of the original arrays mapped through `perm`, never recomputed after
the permutation (a reduction in another order could pick another argmin).
Renumbering and packing alone change no result: the dense search, and the
hashed one at `visited_cap >= N`, return bitwise the ids and distances of
the unoptimized index.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import labels as L
from repro_torch.core.distributed import distributed_search as run_distributed_search
from repro_torch.core import vecstore as VS
from repro_torch.core.search import SearchResult, medoid
from repro_torch.core.search import search as run_search

ORDERS = ("identity", "hub", "bfs")


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# packed fixed-degree adjacency
# ---------------------------------------------------------------------------


def packed_degree(graph_ids) -> int:
    """Largest out-degree over rows: the tightest D that loses no edge."""
    g = torch.as_tensor(graph_ids)
    if g.shape[0] == 0:
        return 1
    return max(int((g >= 0).sum(-1).max()), 1)


def pack_adjacency(graph_ids, degree: int | None = None) -> torch.Tensor:
    """(N, R) pools -> (N, degree) packed int32 adjacency, on the input's
    device (a tensor's, else the CPU).

    Valid ids move to the front of each row by a stable sort on "is
    empty", which keeps their rank order; rows are then -1-padded or cut by
    rank to `degree` columns (default: `packed_degree`, lossless).
    """
    g = graph_ids if isinstance(graph_ids, torch.Tensor) else torch.from_numpy(np.array(graph_ids))
    g = g.to(torch.int32)
    n, r = g.shape
    if degree is None:
        degree = packed_degree(g)
    if degree < 1:
        raise ValueError(f"degree must be at least 1, got {degree}")
    order = torch.sort((g < 0).to(torch.uint8), dim=1, stable=True).indices
    packed = g.gather(1, order)
    if degree <= r:
        return packed[:, :degree].contiguous()
    return torch.nn.functional.pad(packed, (0, degree - r), value=-1)


def unpack_adjacency(packed, r: int) -> torch.Tensor:
    """Inverse of `pack_adjacency` back to pool width `r` (a -1 tail)."""
    p = torch.as_tensor(packed).to(torch.int32)
    if r < p.shape[1]:
        raise ValueError(f"width {r} below the packed degree {p.shape[1]}")
    return torch.nn.functional.pad(p, (0, r - p.shape[1]), value=-1)


# ---------------------------------------------------------------------------
# vertex orderings (numpy, on the host)
# ---------------------------------------------------------------------------


def order_permutation(graph_ids, order: str, *, entry: int = 0, valid=None) -> np.ndarray:
    """Deterministic locality permutation, `perm[old] = new` (int64 numpy).

    "bfs":  breadth-first levels from `entry`, ascending original id within
            a level; unreached and dead vertices keep their order at the tail.
    "hub":  descending in-degree over live edges (ties by original id), dead
            vertices last.
    "identity": no renumbering.
    """
    if order not in ORDERS:
        raise ValueError(f"order must be one of {ORDERS}, got {order!r}")
    g = _np(graph_ids)
    n = g.shape[0]
    ok = np.ones(n, bool) if valid is None else _np(valid).astype(bool).copy()
    if order == "identity":
        return np.arange(n, dtype=np.int64)
    if order == "hub":
        flat = g[(g >= 0) & ok[np.clip(g, 0, n - 1)]]
        indeg = np.bincount(flat, minlength=n)
        # the last key is primary: live first, then in-degree descending,
        # then original id ascending
        new_to_old = np.lexsort((np.arange(n), -indeg, ~ok))
    else:
        seen = np.zeros(n, bool)
        levels = []
        entry = int(entry)
        if ok[entry]:
            seen[entry] = True
            frontier = np.array([entry], dtype=np.int64)
        else:
            frontier = np.array([], dtype=np.int64)
        while frontier.size:
            levels.append(frontier)
            nxt = g[frontier].ravel()
            nxt = np.unique(nxt[nxt >= 0])  # sorted, so deterministic
            nxt = nxt[ok[nxt] & ~seen[nxt]]
            seen[nxt] = True
            frontier = nxt
        tail = np.flatnonzero(~seen)  # unreached and dead, in order
        new_to_old = np.concatenate(levels + [tail]) if levels else tail
    perm = np.empty(n, dtype=np.int64)
    perm[new_to_old] = np.arange(n, dtype=np.int64)
    return perm


# ---------------------------------------------------------------------------
# detour-count pruning
# ---------------------------------------------------------------------------


def detour_counts(ids, dists, *, chunk: int = 512) -> torch.Tensor:
    """(N, R) int32 detour counts of rank-sorted pools.

    The edge v→u (rank j in v's row) is detourable through a closer
    neighbor w = ids[v, i], i < j, when d(w, u) < d(v, u), with d(w, u)
    read from w's pool (u absent there: no detour). Counts such w per edge.
    """
    ids = torch.as_tensor(ids).to(torch.int32)
    dists = torch.as_tensor(dists).to(device=ids.device, dtype=torch.float32)
    n, r = ids.shape
    counts = torch.zeros((n, r), dtype=torch.int32, device=ids.device)
    safe = ids.clamp(0, max(n - 1, 0)).long()
    ranks = torch.arange(r, device=ids.device)
    closer = ranks[:, None] < ranks[None, :]  # (Rw, Ru): i < j
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        iv, dv = ids[lo:hi], dists[lo:hi]  # (C, R)
        w_ids, w_d = ids[safe[lo:hi]], dists[safe[lo:hi]]  # (C, Rw, R)
        match = w_ids[:, :, None, :] == iv[:, None, :, None]  # (C, Rw, Ru, R)
        dwu = torch.where(match, w_d[:, :, None, :], torch.inf).amin(-1)  # (C, Rw, Ru)
        ok = (iv >= 0)[:, :, None] & (iv >= 0)[:, None, :]
        detour = ok & closer[None] & (dwu < dv[:, None, :])
        counts[lo:hi] = detour.sum(1, dtype=torch.int32)
    return counts


def prune_adjacency(ids, dists, degree: int, *, chunk: int = 512) -> torch.Tensor:
    """Keep the `degree` edges per row with the fewest detours (ties by
    rank), in rank order, packed to `degree` columns."""
    ids = torch.as_tensor(ids).to(torch.int32)
    n, r = ids.shape
    degree = min(degree, r)
    counts = detour_counts(ids, dists, chunk=chunk).long()
    rank = torch.arange(r, device=ids.device).expand(n, r)
    key = torch.where(ids >= 0, counts * (r + 1) + rank, torch.iinfo(torch.int64).max)
    keep = torch.sort(torch.sort(key, dim=1, stable=True).indices[:, :degree], dim=1).values
    return pack_adjacency(ids.gather(1, keep), degree)


# ---------------------------------------------------------------------------
# the optimized index
# ---------------------------------------------------------------------------


class OptimizedIndex(NamedTuple):
    """A search-ready index in optimized layout, every tensor on one device
    and in permuted row order; `inv` (new -> old) is the search's
    `ids_map`. `order`, `degree` and `pruned` say how it was made."""

    x: object  # fp32 tensor or VectorStore, rows permuted
    graph_ids: torch.Tensor  # (N, D) packed adjacency, permuted ids
    entry: torch.Tensor  # int32: the permuted medoid
    inv: torch.Tensor  # (N,) int32: inv[new] = old
    perm: torch.Tensor  # (N,) int32: perm[old] = new
    valid: torch.Tensor | None  # permuted tombstone mask
    rescore: object | None  # permuted rescore tier (device or HostTier)
    vwords: torch.Tensor | None  # permuted packed label words
    order: str
    degree: int
    pruned: bool

    @property
    def n(self) -> int:
        return int(self.graph_ids.shape[0])

    def search(self, queries, **kw) -> SearchResult:
        """`core.search.search` over the optimized layout, on the index's
        device unless `device=` says otherwise; ids come back in the
        original numbering."""
        kw.setdefault("entry", self.entry)
        kw.setdefault("valid", self.valid)
        kw.setdefault("rescore", self.rescore)
        kw.setdefault("device", self.graph_ids.device)
        if self.vwords is not None:
            kw.setdefault("labels", self.vwords)
        return run_search(self.x, self.graph_ids, queries, ids_map=self.inv, **kw)

    def distributed_search(self, queries, group=None, **kw) -> SearchResult:
        """`distributed.distributed_search` over the optimized layout, the
        queries split over `group`'s ranks (None: the default group);
        ids come back in the original numbering."""
        kw.setdefault("entry", self.entry)
        kw.setdefault("valid", self.valid)
        kw.setdefault("rescore", self.rescore)
        kw.setdefault("device", self.graph_ids.device)
        if self.vwords is not None:
            kw.setdefault("labels", self.vwords)
        return run_distributed_search(
            self.x, self.graph_ids, queries, group=group, ids_map=self.inv, **kw
        )


def _rows(x, inv: torch.Tensor):
    """A dataset operand (tensor, VectorStore or HostTier) in permuted row
    order."""
    if VS.is_host(x):
        rows = x.data[inv.cpu().long()]
        return VS.HostTier(rows.pin_memory() if x.data.is_pinned() else rows)
    if isinstance(x, VS.VectorStore):
        return x._replace(data=x.data[inv.long()])
    return x[inv.long()]


def optimize(
    x,
    graph,
    *,
    order: str = "bfs",
    degree: int | None = None,
    prune: bool = False,
    valid=None,
    rescore=None,
    labels=None,
    entry=None,
    permutation=None,
    device="cuda",
) -> OptimizedIndex:
    """An `OptimizedIndex` from a built graph (the post-build pass).

    `graph` is a `pools.Pool` or an (N, R) id array (pruning needs the Pool's
    rank distances). `degree=None` packs losslessly to the largest row
    degree; a smaller one cuts by rank or, with `prune=True`, by detour
    count. `order` picks the renumbering; `permutation` (old -> new) overrides
    it. `labels` is a LabelStore or (N, W) words. `entry` defaults to the
    medoid of the original arrays. Tensors end up on `device` (default
    "cuda"; a HostTier rescore stays on the host).
    """
    dev = _device.resolve(device)
    ids = _device.put(graph.ids if hasattr(graph, "ids") else graph, torch.int32, dev)
    n = ids.shape[0]
    x = VS.to_device(x, dev)
    if VS.nrows(x) != n:
        raise ValueError(f"x has {VS.nrows(x)} rows for a graph of {n}")
    if valid is not None:
        valid = _device.put(valid, torch.bool, dev)
    if entry is None:
        entry = medoid(x, valid)
    e_old = int(entry)

    if prune:
        if not hasattr(graph, "dists"):
            raise ValueError("detour pruning needs a Pool (its rank distances)")
        d = degree if degree is not None else packed_degree(ids)
        packed = prune_adjacency(ids, _device.put(graph.dists, torch.float32, dev), d)
    else:
        packed = pack_adjacency(ids, degree)

    if permutation is not None:
        perm = _np(permutation).astype(np.int64)
        if perm.shape != (n,) or not np.array_equal(np.sort(perm), np.arange(n)):
            raise ValueError("permutation must be a bijection on [0, N)")
    else:
        perm = order_permutation(packed, order, entry=e_old, valid=valid)
    inv = np.argsort(perm)  # inv[new] = old
    perm_d = torch.from_numpy(perm.astype(np.int32)).to(dev)
    inv_d = torch.from_numpy(inv.astype(np.int32)).to(dev)

    g = torch.where(packed >= 0, perm_d[packed.clamp_min(0).long()], -1)[inv_d.long()]
    rescore_p = None
    if rescore is not None:
        rescore_p = _rows(rescore if VS.is_host(rescore) else VS.to_device(rescore, dev), inv_d)
    vwords_p = None
    if labels is not None:
        vwords_p = _device.put(L.store_words(labels), torch.int32, dev)[inv_d.long()]
    return OptimizedIndex(
        x=_rows(x, inv_d),
        graph_ids=g.contiguous(),
        entry=perm_d[e_old].clone(),
        inv=inv_d,
        perm=perm_d,
        valid=None if valid is None else valid[inv_d.long()],
        rescore=rescore_p,
        vwords=vwords_p,
        order="custom" if permutation is not None else order,
        degree=int(g.shape[1]),
        pruned=bool(prune),
    )
