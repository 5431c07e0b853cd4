"""kNN-LM: the GRNND index as a serving feature (a port of the JAX package's
`retrieval/knn_lm.py`).

A datastore of (hidden-state, next-token) pairs is indexed with the GRNND
graph; at decode time the LM's post-`final_norm` hidden state queries the
graph, the retrieved neighbors vote on the next token, and the
distributions are fused in log space:

    p(y) = (1 - lam) * p_LM(y) + lam * softmax_k(-d_k / tau) [y == y_k]

Two datastore shapes:

  * `KNNDatastore`, the frozen array-backed reference: (keys, values, graph)
    searched with `core.search.search`; the parity oracle of the production
    path (bitwise at fp32, pinned to the same entry and validity view);
  * `DynamicDatastore`, the production path: a `core.dynamic.DynamicIndex`
    over the pairs, so retrieval runs on the hand-written kernels (int8 /
    bf16 traversal with an fp32 rescore, the host rescore tier, source
    filters, streaming inserts during decode), optionally behind the
    continuous-batching `serve.ann_engine.AnnEngine`.

The vote is a normalized log-distribution with true ``-inf`` support, so
`fuse` keeps total mass 1 at any vocab size; a query with no support at all
falls back to the pure LM. The vote is deterministic on the card: each
row's weights of equal tokens are summed in slot order first (over the
(Q, k, k) token-equality matrix), so the write into the vocab row carries
one value per token, where a float scatter-add would sum duplicates in an
order the card does not fix.

Where the reference takes a `jax.random` key, the port takes `draws=`, the
build's `core.draws.Draws`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import grnnd
from repro_torch.core import pools as P
from repro_torch.core.dynamic import DynamicConfig, DynamicIndex
from repro_torch.core.search import search
from repro_torch.serve.ann_engine import AnnEngine, DynamicWorker, EngineConfig


class KNNDatastore(NamedTuple):
    keys: torch.Tensor  # (N, D) fp32 hidden states
    values: torch.Tensor  # (N,) int32 next-token ids
    graph: torch.Tensor  # (N, R) int32 GRNND adjacency


DEFAULT_BUILD_CFG = grnnd.GRNNDConfig(s=12, r=24, t1=3, t2=3, pairs_per_vertex=24)


def build_datastore(hidden_states, next_tokens, cfg: grnnd.GRNNDConfig | None = None, *,
                    draws=None, device="cuda") -> KNNDatastore:
    """Index (hidden, next-token) pairs with a GRNND graph (array-backed)."""
    dev = _device.resolve(device)
    x = _device.put(hidden_states, torch.float32, dev)
    pool = grnnd.build_graph(x, cfg or DEFAULT_BUILD_CFG, draws=draws, device=dev)
    return KNNDatastore(keys=x, values=_device.put(next_tokens, torch.int32, dev), graph=pool.ids)


def vote_log_probs(ids, dists, toks, vocab: int, tau: float = 10.0) -> torch.Tensor:
    """Neighbor vote -> normalized next-token log-distribution (Q, vocab).

    ids (Q, k) mark valid slots (>= 0), dists (Q, k) their squared
    distances, toks (Q, k) their stored next tokens. Weights are
    softmax(-d / tau) over the valid slots, summed per token; unvoted tokens
    are ``-inf``, voted rows are logsumexp-normalized, and a row with no
    valid slot is all ``-inf`` (`fuse`'s pure-LM fallback).
    """
    w = torch.softmax(-dists / tau, dim=-1)
    w = torch.where(ids >= 0, w, 0.0)
    # per slot, the sum of the weights of every slot holding its token, in
    # slot order: equal tokens get equal sums, so the scatter below writes
    # one value per token whichever duplicate lands last
    same = toks[:, :, None] == toks[:, None, :]  # (Q, k, k): [q, slot, other]
    acc = torch.zeros_like(w)
    for i in range(w.shape[1]):
        acc = acc + torch.where(same[:, :, i], w[:, i : i + 1], 0.0)
    probs = torch.zeros((ids.shape[0], vocab), dtype=torch.float32, device=w.device)
    probs.scatter_(1, toks.long(), acc)
    logp = torch.where(probs > 0, torch.log(probs), -torch.inf)
    lse = torch.logsumexp(logp, dim=-1, keepdim=True)
    return torch.where(torch.isfinite(lse), logp - lse, -torch.inf)


def knn_logits(store: KNNDatastore, queries, vocab: int, *, k: int = 8, ef: int = 32,
               tau: float = 10.0, **search_kw) -> torch.Tensor:
    """Retrieve k neighbors a query and form the kNN log-distribution.

    Extra keywords pass to `core.search.search` (entry=, valid=, visited=,
    ...): the parity checks pin this path to a `DynamicDatastore`'s
    traversal with them."""
    dev = store.keys.device
    res = search(store.keys, store.graph, _device.put(queries, torch.float32, dev), k=k, ef=ef,
                 device=dev, **search_kw)
    toks = store.values[res.ids.clamp_min(0).long()]
    return vote_log_probs(res.ids, res.dists, toks, vocab, tau)


def fuse(lm_logits, knn_log_probs, lam: float = 0.25) -> torch.Tensor:
    """Log-space interpolation of the LM and kNN distributions.

    `knn_log_probs` must be a normalized log-distribution whose unsupported
    tokens are exactly ``-inf`` (`vote_log_probs`): the fused mass is then
    (1 - lam) + lam = 1 at any vocab size. Rows with no support fall back
    to the pure LM distribution."""
    lm_lp = torch.log_softmax(lm_logits, dim=-1)
    fused = torch.logaddexp(lm_lp + math.log1p(-lam), knn_log_probs + math.log(lam))
    has_support = torch.isfinite(torch.logsumexp(knn_log_probs, dim=-1, keepdim=True))
    return torch.where(has_support, fused, lm_lp)


class DynamicDatastore:
    """A kNN-LM datastore on the production index stack.

    A `DynamicIndex` over the (hidden -> next-token) pairs plus the
    label-indexed token table: the index issues a monotone external label
    per inserted row (stable across compaction and layout), so
    ``values[label]`` is the token lookup. `add` streams new pairs in during
    decode; `knn_log_probs` routes every query through the index's search
    (quantized traversal + fp32 rescore per `precision`, the host tier per
    `tier`, source predicates per `filter=`), with the visited set the
    datastore was made with (`visited=`; the reference searches with the
    dense mask, the default). `attach_engine()` puts the
    queries and inserts behind an `AnnEngine`.
    """

    def __init__(self, index: DynamicIndex, values, vocab: int, *, k: int = 8, ef: int = 32,
                 tau: float = 10.0, visited: str = "dense"):
        values = _device.put(values, torch.int32, index.device)
        if values.shape != (index._next_label,):
            raise ValueError(
                f"need one stored token per issued label: {tuple(values.shape)} for "
                f"{index._next_label} labels"
            )
        self.index = index
        self.vocab = int(vocab)
        self.k, self.ef, self.tau = int(k), int(ef), float(tau)
        self.visited = visited
        self.values = values
        self._engine = None

    # -- construction -----------------------------------------------------

    @classmethod
    def build(cls, hidden_states, next_tokens, vocab: int, *,
              build_cfg: grnnd.GRNNDConfig | None = None, precision: str = "int8",
              tier: str = "device", sources=None, n_sources: int | None = None,
              dyn_cfg: DynamicConfig | None = None, draws=None, device="cuda",
              **knn_kw) -> DynamicDatastore:
        """GRNND-build the pairs (fp32, with `draws`), then wrap them in a
        `DynamicIndex` at `precision` / `tier`. `sources` tags each pair
        with a document-source label in [0, n_sources), which `filter=`
        then restricts retrieval by."""
        dev = _device.resolve(device)
        x = _device.put(hidden_states, torch.float32, dev)
        dyn = (dyn_cfg or DynamicConfig())._replace(precision=precision, tier=tier)
        pool = grnnd.build_graph(x, build_cfg or DEFAULT_BUILD_CFG, draws=draws, device=dev)
        index = DynamicIndex(x, pool, dyn, device=dev, vertex_labels=sources, n_labels=n_sources)
        return cls(index, next_tokens, vocab, **knn_kw)

    @classmethod
    def empty(cls, dim: int, vocab: int, *, r: int = 16, precision: str = "int8",
              tier: str = "device", n_sources: int | None = None,
              dyn_cfg: DynamicConfig | None = None, device="cuda", **knn_kw) -> DynamicDatastore:
        """A zero-entry datastore that exists to be streamed into (the first
        `add` bootstraps the graph off its own batch)."""
        dev = _device.resolve(device)
        dyn = (dyn_cfg or DynamicConfig())._replace(precision=precision, tier=tier)
        pool = P.Pool(torch.zeros((0, r), dtype=torch.int32), torch.zeros((0, r)))
        sources = None if n_sources is None else np.zeros((0,), np.int32)
        index = DynamicIndex(torch.zeros((0, dim)), pool, dyn, device=dev,
                             vertex_labels=sources, n_labels=n_sources)
        return cls(index, torch.zeros((0,), dtype=torch.int32), vocab, **knn_kw)

    def __len__(self) -> int:
        return len(self.index)

    # -- serving ----------------------------------------------------------

    def attach_engine(self, cfg=None, **engine_kw):
        """Route queries and inserts through an `AnnEngine` over a
        `DynamicWorker` with this datastore's visited set; returns the
        engine (its `stats()` read the per-step retrieval latency)."""
        if cfg is None:
            cfg = EngineConfig(ef_menu=(self.ef,), k_cap=max(16, self.k))
        worker = DynamicWorker(self.index, visited=self.visited)
        self._engine = AnnEngine(worker, cfg, **engine_kw)
        return self._engine

    def add(self, hidden_states, next_tokens, sources=None) -> torch.Tensor:
        """Insert a batch of (hidden, next-token) pairs; returns their labels.

        Batched insert + localized refinement keep the graph searchable
        between decode steps, so tokens written here are retrievable by the
        same generation's later steps. Through an attached engine the insert
        rides its mutation queue, drained before returning."""
        dev = self.index.device
        xs = _device.put(hidden_states, torch.float32, dev)
        toks = _device.put(next_tokens, torch.int32, dev).reshape(-1)
        if xs.shape[0] != toks.shape[0]:
            raise ValueError(f"{xs.shape[0]} hidden states for {toks.shape[0]} tokens")
        if self._engine is not None:
            self._engine.submit_insert(xs.cpu().numpy(), labels=sources)
            self._engine.run()
            # labels are issued at insert execution; the drained queue
            # gives this batch the latest block
            nl = self.index._next_label
            labels = torch.arange(nl - len(toks), nl, dtype=torch.int64, device=dev)
        else:
            labels = self.index.insert(xs, vertex_labels=sources)
        self.values = torch.cat([self.values, toks])
        if self.values.shape[0] != self.index._next_label:
            raise RuntimeError("the token table lost step with the index's labels")
        return labels

    def _search(self, queries, *, k: int, ef: int, filter=None):
        if self._engine is None:
            res = self.index.search(queries, k=k, ef=ef, filter=filter, visited=self.visited)
            return res.ids, res.dists
        fw = None if filter is None else self.index._query_words(filter).cpu().numpy()
        qn = queries.cpu().numpy()
        rids = [
            self._engine.submit(qn[i], k=k, ef=ef, filter_words=None if fw is None else fw[i])
            for i in range(qn.shape[0])
        ]
        self._engine.run()
        done = [self._engine.take_result(r) for r in rids]
        dev = self.index.device
        return (torch.from_numpy(np.stack([r.ids for r in done])).to(dev),
                torch.from_numpy(np.stack([r.dists for r in done])).to(dev))

    def knn_log_probs(self, queries, *, k: int | None = None, ef: int | None = None,
                      tau: float | None = None, filter=None) -> torch.Tensor:
        """Retrieve + vote: the production counterpart of `knn_logits`.

        `filter` restricts retrieval to matching document sources
        (`core/labels.py` query forms; needs `sources=` at build). An empty
        datastore has no support anywhere: all-``-inf`` rows, so `fuse`
        serves the pure LM until the first `add` lands."""
        k = self.k if k is None else k
        ef = self.ef if ef is None else ef
        tau = self.tau if tau is None else tau
        q = _device.put(queries, torch.float32, self.index.device)
        if len(self) == 0:
            return torch.full((q.shape[0], self.vocab), -torch.inf, device=q.device)
        ids, dists = self._search(q, k=k, ef=ef, filter=filter)
        toks = self.values[ids.clamp_min(0).long()]
        return vote_log_probs(ids, dists, toks, self.vocab, tau)


def make_logit_hook(store, vocab: int | None = None, lam: float = 0.25, **knn_kw):
    """Adapter for `ServeEngine(logit_hook=...)`: fuses retrieval into
    decode. The hook gets ``(lm_logits, hidden)`` and queries the datastore
    with the hidden state; `store` is either datastore shape, and `vocab`
    is needed only for the array-backed one."""
    dynamic = isinstance(store, DynamicDatastore)
    if not dynamic and vocab is None:
        raise ValueError("array-backed KNNDatastore needs vocab=")

    def hook(lm_logits, hidden):
        q = hidden.float()
        if dynamic:
            klp = store.knn_log_probs(q, **knn_kw)
        else:
            klp = knn_logits(store, q, vocab, **knn_kw)
        return fuse(lm_logits, klp, lam)

    return hook


def make_stream_hook(store: DynamicDatastore, *, insert_every: int = 8, sources_fn=None):
    """Adapter for `ServeEngine(token_hook=...)`: stream the decode's own
    (hidden, sampled-token) pairs into the datastore during generation.

    Pairs are buffered and inserted every `insert_every` steps (equal-sized
    batches at a fixed decode batch); `sources_fn(B)` optionally labels the
    rows with a document source. Call ``hook.flush()`` after `generate` to
    commit the tail batch."""
    buf_h: list[torch.Tensor] = []
    buf_t: list[torch.Tensor] = []
    dev = store.index.device

    def flush():
        if buf_h:
            h, t = torch.cat(buf_h), torch.cat(buf_t)
            src = None if sources_fn is None else sources_fn(len(t))
            store.add(h, t, sources=src)
            buf_h.clear()
            buf_t.clear()

    def hook(hidden, tokens):
        buf_h.append(_device.put(hidden, torch.float32, dev).clone())
        buf_t.append(_device.put(tokens, torch.int32, dev).reshape(-1).clone())
        if len(buf_h) >= insert_every:
            flush()

    hook.flush = flush
    return hook
