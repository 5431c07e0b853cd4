"""Continuous-batching ANN serving engine.

A port of the JAX package's `serve/ann_engine.py`. Real traffic is a stream
of small heterogeneous requests (mixed k / ef / filter, plus online inserts
and deletes); this module turns that stream into the uniform shapes the
beam search wants:

* **queue + admission**: `submit()` appends to a FIFO; past
  `EngineConfig.max_pending` the engine sheds load (`EngineSaturated`)
  instead of growing an unbounded backlog.
* **batch shaping**: each step coalesces the head-of-line request with
  every queued request sharing its `(ef, filtered?)` signature, pads the
  stack to the next power-of-two Q bucket by repeating the last real row,
  and runs ONE search call. Every op of the port's beam step is per query
  row, so the grouping and the padding leave each request's result
  bitwise what a direct `core.search.search` call gives it.
* **bounded shapes**: Q buckets are powers of two, ef is normalized
  against `EngineConfig.ef_menu` at admission, and every batch runs at the
  fixed `min(k_cap, ef)` result width, then slices per request: the
  distinct `(Q bucket, ef, filtered)` shapes (`n_buckets`) are bounded by
  |buckets| x |menu| x 2 whatever the request mix.
* **mutation interleave**: mutations run BETWEEN query batches under a
  quantum policy (one mutation per `query_quantum` query batches while
  both queues are backed up), not in lockstep with them.
* **stats**: nearest-rank p50 / p99 latency, QPS, mutations/s, batch
  occupancy, per-bucket run counts.

The scheduler, the traces and `replay` run on numpy and the standard
library; the clock is injectable and the worker is a two-method protocol
(`search_batch`, `apply_mutation`), so every scheduling decision is
deterministic and testable with a fake worker. The workers run the port's
searches: `StaticWorker` (`core.search.search`), `DynamicWorker`
(`core.dynamic.DynamicIndex`) and `ShardedWorker`
(`core.corpus_shard.CorpusShardedIndex`). `search_batch` returns host
numpy arrays; that copy is the batch's one wait for the card, so a
result's `t_done` is when its batch finished on the card.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import labels as L
from repro_torch.core import vecstore as VS
from repro_torch.core.search import medoid, search


class EngineSaturated(RuntimeError):
    """Admission control rejected the request (queue at max_pending)."""


class EngineConfig(NamedTuple):
    """Scheduler knobs.

    `ef_menu` bounds the distinct batch shapes: an admitted ef is rounded
    UP to the smallest menu entry (raising ef only improves recall); values
    beyond the menu are served exactly, each one more shape. An empty menu
    serves every requested ef exactly. `k_cap` is the fixed result width
    batches run at (requests slice their own k from it); k only slices the
    final merged list, so the slice is bitwise a direct call at the same
    ef.
    """

    max_pending: int = 1024
    max_batch: int = 64
    query_quantum: int = 4
    overfetch: int = 4
    ef_menu: tuple = (32, 48, 64, 96, 128)
    k_cap: int = 16


@dataclasses.dataclass
class QueryRequest:
    rid: int
    vector: np.ndarray
    k: int
    ef: int  # admission-normalized (menu + filtered over-fetch applied)
    fwords: np.ndarray | None
    t_submit: float


@dataclasses.dataclass
class MutationRequest:
    kind: str  # "insert" | "delete" | "delete_oldest"
    n_items: int
    vectors: np.ndarray | None = None
    labels: np.ndarray | None = None
    t_submit: float = 0.0


class QueryResult(NamedTuple):
    ids: np.ndarray  # (k,) row ids (static, sharded) or external labels (dynamic)
    dists: np.ndarray  # (k,) float32
    t_submit: float
    t_done: float

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


class EngineStats(NamedTuple):
    n_completed: int
    n_rejected: int
    n_mutations: int  # individual vectors inserted / deleted, not requests
    p50_ms: float
    p99_ms: float
    qps: float
    mutations_per_sec: float
    mean_occupancy: float  # real rows / padded bucket rows, mean over batches
    n_buckets: int  # distinct (Q bucket, ef, filtered) shapes run since startup
    bucket_runs: dict  # (qb, ef, filtered) -> batches run in this window


def percentile(values, p: float) -> float:
    """Nearest-rank percentile: sorted[ceil(p/100 * n) - 1], clamped.

    The rule is fixed (not interpolated) so hand-computed traces stay
    exact: p50 of [1, 2, 3, 4] is 2, p99 is 4.
    """
    if not values:
        return 0.0
    xs = sorted(values)
    i = max(0, min(len(xs) - 1, math.ceil(p / 100.0 * len(xs)) - 1))
    return xs[i]


def bucket_q(n: int) -> int:
    """Next power-of-two Q bucket (>= 1) for a batch of n real requests."""
    return 1 << max(0, (n - 1).bit_length())


def normalize_ef(cfg: EngineConfig, k: int, ef: int, filtered: bool) -> int:
    """Admission-time ef: the over-fetch floor for filtered requests (what
    a direct `core.search.search` call applies inside), then the menu
    round-up. The worker runs at this value with overfetch=1, so a batch
    equals a direct call whose effective ef lands on the same number."""
    if filtered:
        ef = max(ef, cfg.overfetch * k)
    for m in cfg.ef_menu:
        if m >= ef:
            return m
    return ef


class AnnEngine:
    """Request queue + batch-shaping scheduler, running a worker.

    `worker` implements `search_batch(q, *, k, ef, fwords)` -> (ids, dists)
    host arrays and `apply_mutation(mut)` (`StaticWorker`, `DynamicWorker`,
    `ShardedWorker`, or a test fake); `clock` is any zero-argument float
    callable.
    """

    def __init__(
        self,
        worker,
        cfg: EngineConfig = EngineConfig(),
        *,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.worker = worker
        self.cfg = cfg
        self.clock = clock
        self._queries: deque[QueryRequest] = deque()
        self._mutations: deque[MutationRequest] = deque()
        self._results: dict[int, QueryResult] = {}
        self._next_rid = 0
        self._since_mut = 0
        # the distinct batch shapes survive reset_stats()
        self._buckets_seen: dict = {}
        self.reset_stats()

    # -- admission ----------------------------------------------------------

    def submit(self, vector, *, k: int = 10, ef: int = 64, filter_words=None) -> int:
        """Admit one query; returns its request id.

        Raises EngineSaturated (and counts the rejection) past
        `max_pending`. `filter_words` is the (W,) packed predicate of this
        request (`core/labels.py`), or None for unfiltered.
        """
        if not 1 <= k <= min(self.cfg.k_cap, ef):
            raise ValueError(f"need 1 <= k <= min(k_cap={self.cfg.k_cap}, ef={ef}); got k={k}")
        if len(self._queries) >= self.cfg.max_pending:
            self.n_rejected += 1
            raise EngineSaturated(f"query queue at max_pending={self.cfg.max_pending}")
        filtered = filter_words is not None
        ef = normalize_ef(self.cfg, k, ef, filtered)
        rid = self._next_rid
        self._next_rid += 1
        t = self.clock()
        if self._t_first_submit is None:
            self._t_first_submit = t
        self._queries.append(
            QueryRequest(
                rid=rid,
                vector=np.asarray(vector, np.float32),
                k=k,
                ef=ef,
                fwords=None if filter_words is None else np.asarray(filter_words, np.int32),
                t_submit=t,
            )
        )
        return rid

    def _submit_mutation(self, mut: MutationRequest) -> None:
        if len(self._mutations) >= self.cfg.max_pending:
            self.n_rejected += 1
            raise EngineSaturated(f"mutation queue at max_pending={self.cfg.max_pending}")
        mut.t_submit = self.clock()
        if self._t_first_submit is None:
            self._t_first_submit = mut.t_submit
        self._mutations.append(mut)

    def submit_insert(self, vectors, labels=None) -> None:
        vectors = np.asarray(vectors, np.float32)
        self._submit_mutation(
            MutationRequest(
                kind="insert",
                n_items=len(vectors),
                vectors=vectors,
                labels=None if labels is None else np.asarray(labels, np.int32),
            )
        )

    def submit_delete(self, labels) -> None:
        labels = np.asarray(labels)
        self._submit_mutation(MutationRequest(kind="delete", n_items=len(labels), labels=labels))

    def submit_delete_oldest(self, n: int) -> None:
        """Delete the n oldest live external labels at EXECUTION time (the
        sliding-window churn workload: the index assigns labels when an
        insert runs, so a trace cannot know them at submit time)."""
        self._submit_mutation(MutationRequest(kind="delete_oldest", n_items=n))

    # -- scheduling ---------------------------------------------------------

    @property
    def pending_queries(self) -> int:
        return len(self._queries)

    @property
    def pending_mutations(self) -> int:
        return len(self._mutations)

    def step(self) -> bool:
        """One scheduling decision: run one mutation request or one shaped
        query batch. Returns False when both queues are empty.

        A pending mutation runs when the query queue is empty OR
        `query_quantum` query batches have run since the last mutation:
        queries cannot starve mutations, and mutations cannot stall a
        backed-up query queue for more than one request.
        """
        if self._mutations and (not self._queries or self._since_mut >= self.cfg.query_quantum):
            self._run_mutation()
            return True
        if self._queries:
            self._run_query_batch()
            return True
        return False

    def run(self, max_steps: int | None = None) -> int:
        """Step until idle (or max_steps); returns the steps taken."""
        n = 0
        while (max_steps is None or n < max_steps) and self.step():
            n += 1
        return n

    def take_result(self, rid: int) -> QueryResult:
        return self._results.pop(rid)

    def _run_mutation(self) -> None:
        mut = self._mutations.popleft()
        self.worker.apply_mutation(mut)
        t = self.clock()
        self._t_last_done = t
        self._mut_lat.append(t - mut.t_submit)
        self.n_mutations += mut.n_items
        self._since_mut = 0
        self.log.append(("mutation", mut.kind, mut.n_items))

    def _run_query_batch(self) -> None:
        head = self._queries[0]
        key = (head.ef, head.fwords is not None)
        group: list[QueryRequest] = []
        rest: deque[QueryRequest] = deque()
        while self._queries:
            r = self._queries.popleft()
            if len(group) < self.cfg.max_batch and (r.ef, r.fwords is not None) == key:
                group.append(r)
            else:
                rest.append(r)
        self._queries = rest

        ef, filtered = key
        qb = bucket_q(len(group))
        pad = qb - len(group)
        # pad rows repeat the last real request: each query row's search is
        # independent of the others, and a duplicate of real work converges
        # in the same number of beam steps
        q = np.stack([r.vector for r in group] + [group[-1].vector] * pad)
        fw = None
        if filtered:
            fw = np.stack([r.fwords for r in group] + [group[-1].fwords] * pad)
        k_exec = min(self.cfg.k_cap, ef)
        ids, dists = self.worker.search_batch(q, k=k_exec, ef=ef, fwords=fw)
        t = self.clock()
        self._t_last_done = t
        for i, r in enumerate(group):
            self._results[r.rid] = QueryResult(
                ids=np.asarray(ids)[i, : r.k],
                dists=np.asarray(dists)[i, : r.k],
                t_submit=r.t_submit,
                t_done=t,
            )
            self._lat.append(t - r.t_submit)
        self.n_completed += len(group)
        self._occ.append(len(group) / qb)
        bkey = (qb, ef, filtered)
        self._buckets_seen[bkey] = self._buckets_seen.get(bkey, 0) + 1
        self._bucket_runs[bkey] = self._bucket_runs.get(bkey, 0) + 1
        self._since_mut += 1
        self.log.append(("query", bkey, len(group)))

    # -- stats --------------------------------------------------------------

    def reset_stats(self) -> None:
        """Clear the measurement window (e.g. after a warm-up replay). The
        set of distinct batch shapes survives, so `n_buckets` keeps
        counting the shapes run since startup."""
        self._lat: list[float] = []
        self._mut_lat: list[float] = []
        self._occ: list[float] = []
        self._bucket_runs: dict = {}
        self.n_completed = 0
        self.n_rejected = 0
        self.n_mutations = 0
        self._t_first_submit: float | None = None
        self._t_last_done: float | None = None
        self.log: list[tuple] = []

    def stats(self) -> EngineStats:
        window = 0.0
        if self._t_first_submit is not None and self._t_last_done is not None:
            window = self._t_last_done - self._t_first_submit
        return EngineStats(
            n_completed=self.n_completed,
            n_rejected=self.n_rejected,
            n_mutations=self.n_mutations,
            p50_ms=percentile(self._lat, 50) * 1e3,
            p99_ms=percentile(self._lat, 99) * 1e3,
            qps=self.n_completed / window if window > 0 else 0.0,
            mutations_per_sec=self.n_mutations / window if window > 0 else 0.0,
            mean_occupancy=sum(self._occ) / len(self._occ) if self._occ else 0.0,
            n_buckets=len(self._buckets_seen),
            bucket_runs=dict(self._bucket_runs),
        )


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------


def _host(res):
    """(ids, dists) of a SearchResult as host numpy arrays (the batch's
    one wait for the card)."""
    return res.ids.cpu().numpy(), res.dists.cpu().numpy()


def _fwords(fwords):
    return None if fwords is None else torch.from_numpy(np.asarray(fwords, np.int32))


class StaticWorker:
    """Runs engine batches through `core.search.search` over a frozen index.

    Takes the whole serving configuration: a traversal tier (fp32 rows or
    a `VectorStore`) with an fp32 rescore tier on the card or in a host
    `vecstore.HostTier` (the host re-rank is per row like everything else,
    so batching stays bitwise invisible), a `LabelStore` (or packed words)
    for filtered requests, the layout pass's `ids_map` with its permuted
    entry, and the visited-set choice. Every operand moves to `device`
    (default "cuda"; raises without a card) once, here; the entry defaults
    to the medoid of the live rows. Mutations are unsupported.
    """

    def __init__(
        self,
        x,
        graph_ids,
        *,
        entry=None,
        visited: str = "dense",
        visited_cap: int | None = None,
        valid=None,
        rescore=None,
        labels=None,
        ids_map=None,
        device="cuda",
    ):
        dev = _device.resolve(device)
        self.device = dev
        self.x = VS.to_device(x, dev)
        self.graph_ids = _device.put(graph_ids, torch.int32, dev)
        self.valid = None if valid is None else _device.put(valid, torch.bool, dev)
        self.entry = (
            medoid(self.x, self.valid) if entry is None else _device.put(entry, torch.int32, dev)
        )
        self.visited = visited
        self.visited_cap = visited_cap
        if rescore is not None and not VS.is_host(rescore):
            rescore = VS.to_device(rescore, dev)
        self.rescore = rescore
        self.vwords = None
        if labels is not None:
            self.vwords = _device.put(L.store_words(labels), torch.int32, dev)
        self.ids_map = None if ids_map is None else _device.put(ids_map, torch.int32, dev)

    def search_batch(self, q, *, k: int, ef: int, fwords=None):
        filtered = fwords is not None
        if filtered and self.vwords is None:
            raise ValueError("filtered request against a worker built without labels")
        # overfetch=1: admission already applied the over-fetch floor, so
        # the ef here is a direct call's effective ef
        res = search(
            self.x,
            self.graph_ids,
            torch.from_numpy(np.asarray(q, np.float32)),
            k=k,
            ef=ef,
            entry=self.entry,
            visited=self.visited,
            visited_cap=self.visited_cap,
            valid=self.valid,
            rescore=self.rescore,
            labels=self.vwords if filtered else None,
            filter=_fwords(fwords),
            overfetch=1,
            ids_map=self.ids_map,
            device=self.device,
        )
        return _host(res)

    def apply_mutation(self, mut: MutationRequest) -> None:
        raise RuntimeError("StaticWorker serves a frozen index; use DynamicWorker")


class DynamicWorker:
    """Runs engine batches through a `core.dynamic.DynamicIndex`: queries
    return EXTERNAL LABELS, and insert / delete / delete_oldest mutations
    apply to the live index between query batches, on the index's
    device."""

    def __init__(self, index, *, visited: str = "dense", visited_cap: int | None = None):
        self.index = index
        self.visited = visited
        self.visited_cap = visited_cap

    def search_batch(self, q, *, k: int, ef: int, fwords=None):
        res = self.index.search(
            torch.from_numpy(np.asarray(q, np.float32)),
            k=k,
            ef=ef,
            visited=self.visited,
            visited_cap=self.visited_cap,
            filter=_fwords(fwords),
            overfetch=1,
        )
        return _host(res)

    def apply_mutation(self, mut: MutationRequest) -> None:
        idx = self.index
        if mut.kind == "insert":
            idx.insert(torch.from_numpy(mut.vectors), vertex_labels=mut.labels)
        elif mut.kind == "delete":
            idx.delete(np.asarray(mut.labels))
        elif mut.kind == "delete_oldest":
            idx.delete(idx.oldest_live(mut.n_items))
        else:
            raise ValueError(f"unknown mutation kind {mut.kind!r}")


class ShardedWorker:
    """Runs engine batches through a corpus-sharded index
    (`core.corpus_shard.CorpusShardedIndex`): bitwise the replicated
    search. `group` runs the shards on a `torch.distributed` process
    group's ranks (None: every shard in this process). Frozen, like
    `StaticWorker`."""

    def __init__(
        self, index, *, group=None, visited: str = "dense", visited_cap: int | None = None
    ):
        self.index = index
        self.group = group
        self.visited = visited
        self.visited_cap = visited_cap

    def search_batch(self, q, *, k: int, ef: int, fwords=None):
        res = self.index.search(
            torch.from_numpy(np.asarray(q, np.float32)),
            k=k,
            ef=ef,
            visited=self.visited,
            visited_cap=self.visited_cap,
            filter=_fwords(fwords),
            overfetch=1,
            group=self.group,
        )
        return _host(res)

    def apply_mutation(self, mut: MutationRequest) -> None:
        raise RuntimeError("ShardedWorker serves a frozen index; use DynamicWorker")


# ---------------------------------------------------------------------------
# traces and replay
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TraceEvent:
    t: float  # arrival offset (seconds from trace start)
    kind: str  # "query" | "insert" | "delete_oldest"
    vector: np.ndarray | None = None
    k: int = 10
    ef: int = 48
    fwords: np.ndarray | None = None
    vectors: np.ndarray | None = None  # insert payload
    labels: np.ndarray | None = None
    n: int = 0  # delete_oldest count


def synth_trace(
    rng: np.random.Generator,
    queries: np.ndarray,
    *,
    offered_qps: float,
    k_choices=(10,),
    ef_choices=(48,),
    fwords=None,
    mutation_every: int = 0,
    churn_vectors=None,
    churn_labels=None,
) -> list[TraceEvent]:
    """A deterministic open-loop request trace: one query event per row of
    `queries`, Poisson arrivals at `offered_qps`, per-request k / ef drawn
    from the given menus (and the matching `fwords` row when given; a row
    of None makes that request unfiltered, so one trace can mix both).
    With `mutation_every` > 0, every that-many queries a churn pair
    arrives: insert the next `churn_vectors` batch, then delete_oldest of
    equal size (a sliding-window corpus). The draws are the JAX package's,
    so one `np.random.default_rng` seed gives the same trace in both."""
    queries = np.asarray(queries, np.float32)
    n = queries.shape[0]
    gaps = rng.exponential(1.0 / offered_qps, size=n)
    ks = rng.choice(np.asarray(k_choices), size=n)
    efs = rng.choice(np.asarray(ef_choices), size=n)
    events: list[TraceEvent] = []
    t = 0.0
    n_churn = 0
    for i in range(n):
        t += gaps[i]
        events.append(
            TraceEvent(
                t=t,
                kind="query",
                vector=queries[i],
                k=int(ks[i]),
                ef=int(efs[i]),
                fwords=None if fwords is None or fwords[i] is None else np.asarray(fwords[i]),
            )
        )
        if mutation_every and (i + 1) % mutation_every == 0 and churn_vectors is not None:
            vecs = churn_vectors[n_churn % len(churn_vectors)]
            labs = None if churn_labels is None else churn_labels[n_churn % len(churn_labels)]
            n_churn += 1
            events.append(TraceEvent(t=t, kind="insert", vectors=vecs, labels=labs))
            events.append(TraceEvent(t=t, kind="delete_oldest", n=len(vecs)))
    return events


def replay(engine: AnnEngine, trace, *, idle_sleep: float = 2e-4) -> dict[int, int]:
    """Open-loop replay against the engine's own clock: submit each event
    at its arrival offset, stepping the engine while waiting; drain at the
    end. Saturated submits are shed (the rejection is already counted).
    Returns {trace index -> rid} for admitted queries."""
    rids: dict[int, int] = {}
    t0 = engine.clock()
    for i, ev in enumerate(trace):
        while engine.clock() - t0 < ev.t:
            if not engine.step():
                time.sleep(idle_sleep)
        try:
            if ev.kind == "query":
                rids[i] = engine.submit(ev.vector, k=ev.k, ef=ev.ef, filter_words=ev.fwords)
            elif ev.kind == "insert":
                engine.submit_insert(ev.vectors, labels=ev.labels)
            elif ev.kind == "delete_oldest":
                engine.submit_delete_oldest(ev.n)
            else:
                raise ValueError(f"unknown trace event kind {ev.kind!r}")
        except EngineSaturated:
            pass
    engine.run()
    return rids
