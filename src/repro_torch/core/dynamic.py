"""Dynamic GRNND index: online insert and delete with incremental refinement.

A port of the JAX package's `core/dynamic.py`. `DynamicIndex` wraps a built
`Pool` and keeps it searchable under mutation:

  * **batched insert** — new vertices get seed neighbors from a beam search
    over the current graph (with the tombstone mask), emit symmetric
    insertion requests through the build's staging and merge, then run
    `refine_rounds` *localized* propagation rounds: the fused RNG pair
    evaluation over the touched-vertex frontier only (O(F·P·D) distance
    work for F touched vertices instead of a build round's O(N·P·D));
  * **delete by tombstone** — an (N,) validity mask threaded through the
    `search_expand` kernel: a dead vertex leaves traversal at once while
    the arrays stay put;
  * **compaction** — `compact()` drops dead rows, remaps neighbor ids and
    re-sorts pools; tombstones were already invisible to the search, so
    search results in label space are preserved exactly;
  * **capacity doubling** — vectors, pools, validity and labels live in
    power-of-two padded buffers.

External identity is a monotone int64 **label** (returned by `insert`,
taken by `delete`, reported by `search`); internal slot ids move on
compaction and on the layout pass (`DynamicConfig(layout=)`,
`optimize_layout`), labels never do. A label's slot is a binary search
through an argsort of the label table.

With `DynamicConfig(precision="bf16" | "int8")` the index keeps a quantized
traversal tier beside the fp32 buffer: the constructor re-bases every pool
edge into the traversal tier's distance space (`ops.gather_sqdist`), every
mutation works in that space (frozen quantizer parameters, round-tripped
inserts), and user searches re-rank against the fp32 tier.

With `vertex_labels=` (and the frozen `n_labels`) each slot carries one
filter label (-1 = unlabeled), and `search(filter=)` / `exact_knn(filter=)`
run filtered search over the live and allowed rows (`core/labels.py`).
`DynamicConfig(tier="host")` keeps the fp32 rescore tier in (pinned) host
memory behind a `vecstore.HostTier`; it needs a quantized traversal tier.
`DynamicConfig(layout="bfs" | "hub")` renumbers slots for locality at
construction and after every `compact()`.

With `group=` (a `torch.distributed` process group, the same index on
every rank) the symmetric-edge half of an insert is routed to the owning
ranks (`distributed.sharded_apply_requests`), bitwise the in-process
staging. `corpus_search` serves the index corpus-sharded
(`core/corpus_shard.py`), bitwise `search` in label space.

All other state lives on the index's device (`device=`, default "cuda"),
labels and compaction included; the integers are the JAX package's. Every
random number comes from `draws.localized_pairs`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import corpus_shard as CS
from repro_torch.core import distributed as D
from repro_torch.core import labels as L
from repro_torch.core import layout as LY
from repro_torch.core import pools as P
from repro_torch.core import vecstore as VS
from repro_torch.core.draws import Draws
from repro_torch.core.grnnd import _pair_requests_chunk
from repro_torch.core.search import SearchResult, medoid, search
from repro_torch.kernels import ops

# queries per block of `exact_knn`'s (Q, capacity) distance matrix (4.3 GB
# of fp32 at a 2^20-row capacity)
KNN_BLOCK = 1024


class DynamicConfig(NamedTuple):
    """Mutation-path knobs (the build-time knobs stay in GRNNDConfig)."""

    seed_k: int = 8  # seed neighbors per inserted vertex
    seed_ef: int = 64  # beam width of the seed search
    refine_rounds: int = 2  # localized propagation rounds per insert batch
    pairs_per_vertex: int = 32  # sampled slot pairs per frontier vertex
    incoming_cap: int | None = None  # staged insertions per vertex per round
    compact_threshold: float = 0.25  # tombstone fraction that triggers compact()
    min_capacity: int = 64  # smallest padded buffer
    precision: str = "fp32"  # traversal-tier storage
    tier: str = "device"  # fp32 rescore-tier placement: "device" or "host"
    # (pinned host memory; needs a quantized traversal tier)
    layout: str | None = None  # locality renumbering ("bfs" / "hub"): at
    # construction and after every compact()


def _pow2_capacity(need: int, floor: int) -> int:
    cap = max(floor, 1)
    while cap < need:
        cap *= 2
    return cap


def _apply_seed_requests(
    pool: P.Pool, new_slots, seed_ids, seed_d, r: int, cap: int, group=None
) -> P.Pool:
    """Write the inserted vertices' seed pools and their symmetric edges.

    The new rows' pools are the deduplicated top-r of the seed results
    (written into `pool` in place); the reverse direction (new vertex into
    each seed neighbor's pool) goes through the build's request staging,
    routed to the owning ranks under a `group`.
    """
    sk = seed_ids.shape[1]
    seed_ids, seed_d = seed_ids.contiguous(), seed_d.contiguous()
    row_i, row_d = ops.topr_merge(seed_ids, seed_d, r)
    pool.ids[new_slots.long()] = row_i
    pool.dists[new_slots.long()] = row_d
    req = P.Requests(
        dst=seed_ids.reshape(-1),
        src=new_slots.repeat_interleave(sk),
        dist=seed_d.reshape(-1),
    )
    if group is None:
        return P.insert_requests(pool, req, cap=cap)
    return D.sharded_apply_requests(pool, req, cap, group=group)


def _localized_round(x, pool: P.Pool, frontier, si, sj, cap: int) -> P.Pool:
    """One propagation round restricted to the touched-vertex frontier.

    `frontier` is an (F,) id vector (-1 = inactive pad); only its rows are
    gathered and pair-evaluated. Redirects and kills merge through the
    order-free staging, so the result is a build round in which every
    vertex off the frontier sampled zero pairs.
    """
    n, r = pool.ids.shape
    ok = frontier >= 0
    fr = frontier.clamp_min(0).long()
    ids_c = torch.where(ok[:, None], pool.ids[fr], -1).contiguous()
    dists_c = torch.where(ok[:, None], pool.dists[fr], torch.inf).contiguous()
    redirect, killed = _pair_requests_chunk(x, ids_c, dists_c, si, sj)
    # OR-scatter the frontier's kill mask back to full rows (a vertex on the
    # frontier twice combines its kills, as same-round kills do in the build)
    kill_full = torch.zeros((n, r), dtype=torch.int32, device=pool.ids.device)
    kill_full.index_add_(0, fr, (killed & ok[:, None]).to(torch.int32))
    kill_full = kill_full > 0
    surv_ids = torch.where(kill_full, -1, pool.ids)
    surv_dists = torch.where(kill_full, torch.inf, pool.dists)
    staged_i, staged_d = P.group_requests(redirect, n, cap)
    return P.merge_into(P.Pool(surv_ids, surv_dists), staged_i, staged_d)


def _masked_knn_dists(x, valid, queries) -> torch.Tensor:
    d = ops.pairwise_sqdist(queries, x)
    return torch.where(valid[None, :], d, torch.inf)


# rows of the host fp32 tier streamed to the card per block of `exact_knn`
# (128 MB at D = 128)
HOST_ROW_BLOCK = 1 << 18


class DynamicIndex:
    """A mutable ANN index over padded device buffers.

    State (capacity C, pool width R), on `device` but for `x` under
    `tier="host"`:
      x      (C, D) f32  — exact-tier vectors; rows >= size are zero pads
                           (in pinned host memory under `tier="host"`)
      store              — the traversal-tier VectorStore over (C, D) rows
                           (None at precision "fp32")
      pool   (C, R)      — neighbor ids / dists (ids are internal slots)
      valid  (C,)  bool  — False for tombstones and unallocated pads
      labels (C,)  i64   — external label per slot (-1 = pad)
      vlabels (C,) i32   — the filter label per slot (-1 = unlabeled or
                           pad), None without `vertex_labels`; its space
                           `n_labels` (so the word count W) is frozen

    `size` is the allocated prefix (live + tombstoned), `n_live` the live
    count, `group` the process group inserts are routed over (None: in
    process; `torch.distributed.group.WORLD` for the default group; the
    capacity must split evenly over its ranks), `rounds_run` the localized
    rounds run so far (and the round number `draws.localized_pairs` is
    asked for). The int8 scale/offset
    are frozen at construction; inserts quantize with them.
    """

    def __init__(
        self,
        x,
        pool: P.Pool,
        cfg: DynamicConfig = DynamicConfig(),
        *,
        draws=None,
        device="cuda",
        vertex_labels=None,
        n_labels=None,
        group=None,
    ):
        _check_cfg(cfg)
        self.group = group
        dev = _device.resolve(device)
        x = _device.put(x, torch.float32, dev)
        ids = _device.put(pool.ids, torch.int32, dev)
        dists = _device.put(pool.dists, torch.float32, dev)
        n, d = x.shape
        if ids.shape[0] != n:
            raise ValueError(f"pool has {ids.shape[0]} rows for {n} vectors")
        self.cfg = cfg
        self.r = ids.shape[1]
        self.size = n
        self.n_live = n
        self.rounds_run = 0
        self.draws = draws if draws is not None else Draws(0x0D11, dev)
        self._entry: torch.Tensor | None = None
        self._dev = dev
        self._host_tier: VS.HostTier | None = None

        cap = _pow2_capacity(n, cfg.min_capacity)
        self.x = self._new_x(cap, d)
        self.x[:n] = x.to(self.x.device)
        if cfg.precision == "fp32":
            self.store = None
        else:
            enc = VS.encode(x, cfg.precision)
            data = torch.zeros((cap, d), dtype=enc.data.dtype, device=dev)
            data[:n] = enc.data
            self.store = enc._replace(data=data)
            # re-base the pool's distances into the traversal space: the
            # graph may have been built at fp32, and every later mutation
            # (RNG kills, merge ranks) compares against these values. An
            # empty corpus has no edges, and no rows the kernel could read.
            if n:
                owners = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(self.r)
                d_t = ops.gather_sqdist(enc, owners, ids.reshape(-1).clamp_min(0)).reshape(n, -1)
                d_t = torch.where(ids >= 0, d_t, torch.inf)
                ids, dists = ops.topr_merge(ids, d_t, self.r)
        del x
        self.pool = P.empty_pool(cap, self.r, dev)
        self.pool.ids[:n] = ids
        self.pool.dists[:n] = dists
        self.valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
        self.valid[:n] = True
        self.labels = torch.full((cap,), -1, dtype=torch.int64, device=dev)
        self.labels[:n] = torch.arange(n, dtype=torch.int64, device=dev)
        self._next_label = n
        self.n_labels, self.vlabels = None, None
        if vertex_labels is None:
            if n_labels is not None:
                raise ValueError("n_labels without vertex_labels")
        else:
            vl = _device.put(vertex_labels, torch.int32, dev)
            if vl.shape != (n,):
                raise ValueError(f"vertex_labels must be ({n},), got {tuple(vl.shape)}")
            if n == 0 and n_labels is None:
                raise ValueError("an empty labeled index needs an explicit n_labels")
            self.n_labels = int(n_labels) if n_labels is not None else int(vl.max()) + 1
            if n and int(vl.max()) >= self.n_labels:
                raise ValueError(f"label {int(vl.max())} outside the frozen space {self.n_labels}")
            self.vlabels = torch.full((cap,), -1, dtype=torch.int32, device=dev)
            self.vlabels[:n] = vl
        self._vwords: torch.Tensor | None = None  # packed cache
        if cfg.layout is not None:
            self.optimize_layout(cfg.layout)

    @classmethod
    def from_state(
        cls,
        *,
        x,
        store,
        pool: P.Pool,
        valid,
        labels,
        size: int,
        n_live: int,
        next_label: int,
        entry,
        rounds_run: int = 0,
        vlabels=None,
        n_labels: int | None = None,
        cfg: DynamicConfig = DynamicConfig(),
        draws=None,
        device="cuda",
    ) -> DynamicIndex:
        """An index holding the given state as it is (no re-base, no layout
        pass): the padded fp32 buffer, the traversal store (None at fp32),
        pool, validity, labels, counters, cached entry (None = not cached)
        and the filter labels `vlabels` over the capacity with their
        `n_labels` (None without)."""
        _check_cfg(cfg)
        dev = _device.resolve(device)
        self = cls.__new__(cls)
        self.cfg = cfg
        self.group = None
        self._dev = dev
        self._host_tier = None
        x = _device.put(x, torch.float32, dev)
        self.x = self._new_x(*x.shape)
        self.x.copy_(x)
        self.store = None if store is None else VS.to_device(store, dev)
        self.pool = P.Pool(
            _device.put(pool.ids, torch.int32, dev), _device.put(pool.dists, torch.float32, dev)
        )
        self.r = self.pool.r
        self.valid = _device.put(valid, torch.bool, dev)
        self.labels = _device.put(labels, torch.int64, dev)
        self.size, self.n_live, self._next_label = int(size), int(n_live), int(next_label)
        self.rounds_run = int(rounds_run)
        self._entry = None if entry is None else _device.put(entry, torch.int32, dev)
        self.draws = draws if draws is not None else Draws(0x0D11, dev)
        self.vlabels = None if vlabels is None else _device.put(vlabels, torch.int32, dev)
        self.n_labels = None if vlabels is None else int(n_labels)
        self._vwords = None
        return self

    # -- bookkeeping ------------------------------------------------------

    @property
    def device(self) -> torch.device:
        """Where the index runs (the fp32 buffer may sit on the host)."""
        return self._dev

    def _new_x(self, rows: int, d: int) -> torch.Tensor:
        """A zeroed (rows, D) fp32 buffer: on the device, or under
        `tier="host"` in host memory (pinned when the device is a card)."""
        if self.cfg.tier == "host":
            return torch.zeros((rows, d), dtype=torch.float32, pin_memory=self._dev.type == "cuda")
        return torch.zeros((rows, d), dtype=torch.float32, device=self._dev)

    def _host_idx(self, idx: torch.Tensor) -> torch.Tensor:
        """Slot indices as int64 on the fp32 buffer's device."""
        return idx.to(self.x.device, torch.int64)

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def tombstone_fraction(self) -> float:
        return 1.0 - self.n_live / max(self.size, 1)

    def __len__(self) -> int:
        return self.n_live

    def _tier(self):
        """The traversal-tier dataset the kernels read."""
        return self.store if self.store is not None else self.x

    def _rescore_tier(self):
        """The rescore operand of `search()`: the fp32 buffer under device
        placement, a `HostTier` over it under host placement. The wrapper
        shares the buffer's memory, so inserts show through, and is made
        anew when the buffer is replaced (growth, compaction, layout);
        `fetched_rows` accumulates in between."""
        if self.cfg.tier != "host":
            return self.x
        if self._host_tier is None or self._host_tier.data is not self.x:
            self._host_tier = VS.HostTier(self.x)  # wraps the buffer, no copy
        return self._host_tier

    def entry(self) -> torch.Tensor:
        if self._entry is None:
            self._entry = medoid(self._tier(), self.valid)
        return self._entry

    def _ensure_capacity(self, need: int) -> None:
        cap = self.capacity
        if need <= cap:
            return
        grow = _pow2_capacity(need, cap) - cap
        pad = torch.nn.functional.pad
        x = self._new_x(cap + grow, self.x.shape[1])
        x[:cap] = self.x
        self.x = x
        if self.store is not None:
            self.store = self.store._replace(data=pad(self.store.data, (0, 0, 0, grow)))
        self.pool = P.Pool(
            ids=pad(self.pool.ids, (0, 0, 0, grow), value=-1),
            dists=pad(self.pool.dists, (0, 0, 0, grow), value=torch.inf),
        )
        self.valid = pad(self.valid, (0, grow))
        self.labels = pad(self.labels, (0, grow), value=-1)
        if self.vlabels is not None:
            self.vlabels = pad(self.vlabels, (0, grow), value=-1)
            self._vwords = None

    # -- layout ------------------------------------------------------------

    def optimize_layout(self, order: str | None = None) -> None:
        """Renumber slots for locality (BFS from the medoid, or hubs first:
        `layout.order_permutation`).

        A pure relabeling: external labels, search results in label space
        and later mutations do not change. Vectors, both tiers, pools (rows
        and the ids in them), validity and both label tables are permuted
        together; the cached entry is mapped, never recomputed. Pools keep
        their width R (inserts need the room), so only the renumbering of
        `layout.optimize` applies; inserts land at the tail until the next
        `compact()` re-runs it.
        """
        order = order if order is not None else (self.cfg.layout or "bfs")
        if order not in LY.ORDERS:
            raise ValueError(f"order must be one of {LY.ORDERS}, got {order!r}")
        self.cfg = self.cfg._replace(layout=order)
        size = self.size
        if size <= 1 or self.n_live == 0:
            return
        e = int(self.entry())  # the medoid before the permutation
        perm = LY.order_permutation(
            self.pool.ids[:size], order, entry=e, valid=self.valid[:size]
        )
        self._apply_slot_permutation(perm)

    def _apply_slot_permutation(self, perm: np.ndarray) -> None:
        """Apply `perm[old_slot] = new_slot` over the allocated prefix (pad
        rows past `size` stay put)."""
        size, cap, dev = self.size, self.capacity, self.device
        inv = np.argsort(perm)  # inv[new] = old
        tail = np.arange(size, cap)
        inv_d = torch.from_numpy(np.concatenate([inv, tail])).to(dev)
        perm_d = torch.from_numpy(np.concatenate([perm, tail]).astype(np.int32)).to(dev)

        x = self._new_x(*self.x.shape)
        torch.index_select(self.x, 0, self._host_idx(inv_d), out=x)
        self.x = x
        if self.store is not None:
            # frozen scale / offset: a pure row gather, stored bytes exact
            self.store = self.store._replace(data=self.store.data[inv_d])
        mapped = torch.where(self.pool.ids >= 0, perm_d[self.pool.ids.clamp_min(0).long()], -1)
        self.pool = P.Pool(mapped[inv_d].contiguous(), self.pool.dists[inv_d].contiguous())
        self.valid = self.valid[inv_d]
        self.labels = self.labels[inv_d]
        if self.vlabels is not None:
            self.vlabels = self.vlabels[inv_d]
            self._vwords = None
        if self._entry is not None:
            e = int(self._entry)
            if 0 <= e < size:
                self._entry = torch.tensor(int(perm[e]), dtype=torch.int32, device=dev)

    # -- mutation ---------------------------------------------------------

    def insert(self, xs, vertex_labels=None) -> torch.Tensor:
        """Insert a batch of vectors; returns their (B,) int64 labels.

        Seed neighbors come from a search of the current graph; the
        symmetric edges and `cfg.refine_rounds` localized rounds then stitch
        the batch into the graph without touching its untouched bulk.
        `vertex_labels` are the batch's (B,) filter labels on a labeled index
        (inside the frozen space); without them the batch lands unlabeled
        (-1): searchable unfiltered, matched by no predicate.
        """
        dev = self.device
        xs = _device.put(xs, torch.float32, dev)
        b = xs.shape[0]
        if b == 0 or xs.shape[1] != self.x.shape[1]:
            raise ValueError(f"insert needs a non-empty (B, {self.x.shape[1]}) batch")
        if vertex_labels is not None:
            if self.vlabels is None:
                raise ValueError("this index was built without vertex labels")
            vertex_labels = _device.put(vertex_labels, torch.int32, dev)
            if vertex_labels.shape != (b,) or int(vertex_labels.max()) >= self.n_labels:
                raise ValueError(f"vertex_labels must be ({b},) labels below {self.n_labels}")
        cfg = self.cfg
        cap = cfg.incoming_cap if cfg.incoming_cap is not None else self.r
        seed_k = min(cfg.seed_k, self.r)
        # the batch as stored: seed distances live in the traversal space
        xs_t = xs if self.store is None else self.store.requant(xs)

        if self.n_live > 0:
            # the seed search runs on the pre-insert graph (tombstones and
            # pads masked out), without rescoring: its distances become pool
            # entries, so they must be traversal-space distances
            res = search(
                self._tier(),
                self.pool.ids,
                xs_t,
                k=seed_k,
                ef=max(cfg.seed_ef, seed_k),
                entry=self.entry(),
                valid=self.valid,
                device=dev,
            )
            seed_ids, seed_d = res.ids, res.dists

        self._ensure_capacity(self.size + b)
        new_slots = torch.arange(self.size, self.size + b, dtype=torch.int32, device=dev)

        if self.n_live == 0:
            # an emptied index has no graph to seed from: bootstrap the batch
            # off itself (exact kNN within the batch), lower index first at
            # equal distances as the reference's top_k
            k_boot = min(seed_k, max(b - 1, 1))
            d = ops.pairwise_sqdist(xs_t, xs_t)
            d.fill_diagonal_(torch.inf)
            seed_d, nidx = torch.sort(d, dim=1, stable=True)
            seed_d, nidx = seed_d[:, :k_boot].contiguous(), nidx[:, :k_boot]
            seed_ids = torch.where(torch.isfinite(seed_d), new_slots[nidx], -1)
        self.x[self._host_idx(new_slots)] = xs.to(self.x.device)
        if self.store is not None:
            self.store.with_rows(new_slots, xs)
        self.valid[new_slots.long()] = True
        if self.vlabels is not None:
            if vertex_labels is not None:
                self.vlabels[self.size : self.size + b] = vertex_labels
            self._vwords = None
        out = torch.arange(self._next_label, self._next_label + b, dtype=torch.int64, device=dev)
        self.labels[self.size : self.size + b] = out
        self._next_label += b

        self.pool = _apply_seed_requests(
            self.pool, new_slots, seed_ids, seed_d, self.r, cap, self.group
        )

        # localized refinement over the inserted vertices plus every vertex
        # that received a symmetric edge
        frontier = torch.cat([new_slots, seed_ids.reshape(-1)])
        f, p = frontier.shape[0], cfg.pairs_per_vertex
        for _ in range(cfg.refine_rounds):
            si, sj = self.draws.localized_pairs(self.rounds_run, f, self.r, p)
            si = si.to(device=dev, dtype=torch.int32).contiguous()
            sj = sj.to(device=dev, dtype=torch.int32).contiguous()
            self.pool = _localized_round(self._tier(), self.pool, frontier, si, sj, cap)
            self.rounds_run += 1

        self.size += b
        self.n_live += b
        self._entry = None
        return out

    def delete(self, labels) -> int:
        """Tombstone the given external labels; returns the number removed.

        Queries stop returning (and routing through) the vertices at once;
        `compact()` reclaims the rows, and runs by itself once
        `tombstone_fraction` exceeds `cfg.compact_threshold`. Labels this
        index never issued raise KeyError; already-deleted labels (also ones
        a past compaction reclaimed) are a no-op, so retries are safe.
        """
        if not isinstance(labels, torch.Tensor):
            labels = torch.from_numpy(np.atleast_1d(np.asarray(labels, np.int64)))
        lab = labels.to(device=self.device, dtype=torch.int64).reshape(-1)
        unknown = (lab < 0) | (lab >= self._next_label)
        if bool(unknown.any()):
            raise KeyError(f"unknown labels: {lab[unknown][:8].tolist()}")
        if self.size == 0:
            return 0
        # under a layout permutation the table is not slot-ordered: search
        # through its argsort (the identity when no permutation ran)
        table, sorter = torch.sort(self.labels[: self.size], stable=True)
        pos = torch.searchsorted(table, lab)
        # issued labels absent from the table were compacted away: no-op
        present = (pos < self.size) & (table[pos.clamp_max(self.size - 1)] == lab)
        slots = torch.unique(sorter[pos[present]])
        slots = slots[self.valid[slots]]
        if slots.numel():
            self.valid[slots] = False
            self.n_live -= int(slots.numel())
            # the cached entry survives unless its own slot was tombstoned
            if self._entry is not None and bool((slots == self._entry.long()).any()):
                self._entry = None
        if self.tombstone_fraction > self.cfg.compact_threshold:
            self.compact()
        return int(slots.numel())

    def oldest_live(self, n: int) -> torch.Tensor:
        """The `n` oldest live external labels, ascending. Labels are issued
        in increasing order, so the oldest are the smallest; slot order is
        not label order after a layout pass, hence the sort."""
        live = self.labels[: self.size][self.valid[: self.size]]
        return torch.sort(live).values[:n]

    def compact(self) -> None:
        """Drop tombstoned rows, remap neighbor ids, re-sort pools.

        Tombstones are already invisible to the search, so compaction is a
        pure relabeling: search results in label space are preserved
        exactly. The cached entry is remapped, not recomputed. With
        `cfg.layout` the layout pass then runs again over the kept rows
        (also exact: the entry is mapped through the permutation).
        """
        size, r, dev = self.size, self.r, self.device
        keep = self.valid[:size]
        kept = torch.nonzero(keep).squeeze(1)
        n_new = int(kept.numel())
        new_of_old = torch.full((size,), -1, dtype=torch.int32, device=dev)
        new_of_old[kept] = torch.arange(n_new, dtype=torch.int32, device=dev)

        ids_old = self.pool.ids[:size][kept]
        d_old = self.pool.dists[:size][kept]
        safe = ids_old.clamp(0, max(size - 1, 0)).long()
        nbr_ok = (ids_old >= 0) & keep[safe]
        mapped = torch.where(nbr_ok, new_of_old[safe], -1).contiguous()
        d_new = torch.where(mapped >= 0, d_old, torch.inf).contiguous()

        cap = _pow2_capacity(max(n_new, 1), self.cfg.min_capacity)
        d = self.x.shape[1]
        x_new = self._new_x(cap, d)
        x_new[:n_new] = self.x[self._host_idx(kept)]
        if self.store is not None:
            # frozen scale/offset: a pure row gather, stored bytes exact
            data = torch.zeros((cap, d), dtype=self.store.data.dtype, device=dev)
            data[:n_new] = self.store.data[kept]
            self.store = self.store._replace(data=data)
        # dead neighbors leave holes mid-row: re-sort with the merge primitive
        row_i, row_d = ops.topr_merge(mapped, d_new, r)
        self.pool = P.empty_pool(cap, r, dev)
        self.pool.ids[:n_new] = row_i
        self.pool.dists[:n_new] = row_d
        self.x = x_new
        self.valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
        self.valid[:n_new] = True
        labels = torch.full((cap,), -1, dtype=torch.int64, device=dev)
        labels[:n_new] = self.labels[:size][kept]
        self.labels = labels
        if self.vlabels is not None:
            vl = torch.full((cap,), -1, dtype=torch.int32, device=dev)
            vl[:n_new] = self.vlabels[:size][kept]
            self.vlabels = vl
            self._vwords = None
        if self._entry is not None:
            e = int(self._entry)
            e_new = int(new_of_old[e]) if 0 <= e < size else -1
            self._entry = None if e_new < 0 else torch.tensor(e_new, dtype=torch.int32, device=dev)
        self.size = n_new
        self.n_live = n_new
        if self.cfg.layout is not None:
            self.optimize_layout(self.cfg.layout)

    # -- queries ----------------------------------------------------------

    def _to_labels(self, ids: torch.Tensor) -> torch.Tensor:
        return torch.where(ids >= 0, self.labels[ids.clamp_min(0).long()], -1)

    def label_words(self) -> torch.Tensor:
        """The packed (C, W) label words over the whole padded buffer (pads
        and unlabeled rows are zero words, matched by no predicate); cached
        until an insert, a compaction, a growth or a layout pass."""
        if self.vlabels is None:
            raise ValueError("this index was built without vertex labels")
        if self._vwords is None:
            self._vwords = L.pack_ids(self.vlabels, self.n_labels)
        return self._vwords

    def _query_words(self, filter) -> torch.Tensor:
        if self.vlabels is None:
            raise ValueError("this index was built without vertex labels")
        return _device.put(L.query_words(filter, L.n_words(self.n_labels)), torch.int32, self.device)

    def search(
        self,
        queries,
        *,
        k: int = 10,
        ef: int = 64,
        max_steps: int = 512,
        visited: str = "dense",
        visited_cap: int | None = None,
        rescore: bool | None = None,
        filter=None,
        overfetch: int = 4,
    ) -> SearchResult:
        """Beam search over the live graph; result ids are external labels.

        Traversal reads the traversal tier; at a quantized precision the
        final ef candidates are re-ranked against the fp32 tier
        (`rescore=None` = on iff the traversal tier is quantized), on the
        host under `tier="host"` with bitwise-equal results. `filter` is a
        per-query label predicate (`core/labels.py` forms): tombstones stay
        out of traversal, filtered-out live vertices stay traversable but
        are never returned.
        """
        if rescore is None:
            rescore = self.store is not None
        res = search(
            self._tier(),
            self.pool.ids,
            queries,
            k=k,
            ef=ef,
            max_steps=max_steps,
            entry=self.entry(),
            visited=visited,
            visited_cap=visited_cap,
            valid=self.valid,
            rescore=self._rescore_tier() if rescore else None,
            labels=None if filter is None else self.label_words(),
            filter=None if filter is None else self._query_words(filter),
            overfetch=overfetch,
            device=self.device,
        )
        return SearchResult(self._to_labels(res.ids), res.dists, res.n_expanded)

    def corpus_search(
        self,
        queries,
        n_shards: int,
        *,
        k: int = 10,
        ef: int = 64,
        max_steps: int = 512,
        visited: str = "dense",
        visited_cap: int | None = None,
        rescore: bool | None = None,
        filter=None,
        overfetch: int = 4,
        group=None,
    ) -> SearchResult:
        """Corpus-sharded search over this index (`core/corpus_shard.py`):
        each of `n_shards` shards owns 1/S of the padded buffers (vectors,
        graph rows, validity, label words, the rescore tier, on the host
        under `tier="host"`). Bitwise `search()` in label space for any
        shard count, across insert, delete and compact. The buffers are
        re-sharded on every call. `group` runs the shards on a process
        group's ranks (`corpus_shard.sharded_search`); None in process."""
        if rescore is None:
            rescore = self.store is not None
        idx = CS.shard(
            self._tier(),
            self.pool.ids,
            n_shards,
            valid=self.valid,
            rescore=self._rescore_tier() if rescore else None,
            labels=None if filter is None else self.label_words(),
            entry=self.entry(),
            tier=self.cfg.tier,
            device=self.device,
        )
        res = CS.sharded_search(
            idx,
            queries,
            k=k,
            ef=ef,
            max_steps=max_steps,
            visited=visited,
            visited_cap=visited_cap,
            filter=None if filter is None else self._query_words(filter),
            overfetch=overfetch,
            group=group,
        )
        return SearchResult(self._to_labels(res.ids), res.dists, res.n_expanded)

    def exact_knn(self, queries, k: int, filter=None) -> torch.Tensor:
        """Brute-force ground truth over the live corpus, in label space; with
        `filter`, over the live and allowed corpus (slots past the allowed
        count hold -1). Blocks of KNN_BLOCK queries; a host fp32 tier is
        streamed to the card HOST_ROW_BLOCK rows at a time."""
        queries = _device.put(queries, torch.float32, self.device)
        fwords = None if filter is None else self._query_words(filter)
        words = None if filter is None else self.label_words()
        outs = []
        for lo in range(0, queries.shape[0], KNN_BLOCK):
            qb = queries[lo : lo + KNN_BLOCK]
            fb = None if fwords is None else fwords[lo : lo + KNN_BLOCK]
            if self.x.device == self.device:
                vals, idx = self._knn_block(self.x, qb, fb, words, 0, k)
            else:
                vals, idx = self._knn_streamed(qb, fb, words, k)
            outs.append(torch.where(torch.isfinite(vals), self.labels[idx], -1))
        return torch.cat(outs)

    def _knn_block(self, rows, qb, fb, words, lo: int, k: int):
        """Top-k (vals, slot ids) of queries `qb` over slots [lo, lo + len(rows))."""
        hi = lo + rows.shape[0]
        d = _masked_knn_dists(rows, self.valid[lo:hi], qb)
        if fb is not None:
            d = torch.where(L._hit(words[lo:hi], fb), d, torch.inf)
        vals, idx = torch.topk(d, min(k, hi - lo), dim=1, largest=False)
        return vals, idx + lo

    def _knn_streamed(self, qb, fb, words, k: int):
        vals = torch.full((qb.shape[0], 0), torch.inf, device=self.device)
        idx = torch.zeros((qb.shape[0], 0), dtype=torch.int64, device=self.device)
        for lo in range(0, self.capacity, HOST_ROW_BLOCK):
            rows = self.x[lo : lo + HOST_ROW_BLOCK].to(self.device, non_blocking=True)
            v, i = self._knn_block(rows, qb, fb, words, lo, k)
            vals, order = torch.topk(torch.cat([vals, v], 1), min(k, vals.shape[1] + v.shape[1]),
                                     dim=1, largest=False)
            idx = torch.cat([idx, i], 1).gather(1, order)
        return vals, idx


def _check_cfg(cfg: DynamicConfig) -> None:
    if cfg.precision not in VS.PRECISIONS:
        raise ValueError(f"precision must be one of {VS.PRECISIONS}, got {cfg.precision!r}")
    if cfg.tier not in VS.PLACEMENTS:
        raise ValueError(f"tier must be one of {VS.PLACEMENTS}, got {cfg.tier!r}")
    if cfg.tier == "host" and cfg.precision == "fp32":
        raise ValueError(
            "tier='host' needs a quantized traversal tier (at precision 'fp32' the fp32 "
            "buffer is the traversal tier)"
        )
    if cfg.layout is not None and cfg.layout not in LY.ORDERS:
        raise ValueError(f"layout must be one of {LY.ORDERS}, got {cfg.layout!r}")
