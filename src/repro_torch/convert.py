"""Carry state from the JAX reference into the port.

Every function takes numpy arrays (or anything `np.array` takes: the
reference's arrays convert through `np.asarray`), never JAX objects, so this
module imports nothing of JAX. bf16 arrays (numpy's `bfloat16` extension
dtype, as JAX hands them out) are carried bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.corpus_shard import CorpusShardedIndex
from repro_torch.core.dynamic import DynamicConfig, DynamicIndex
from repro_torch.core.labels import LabelStore
from repro_torch.core.layout import OptimizedIndex
from repro_torch.core.pools import Pool
from repro_torch.core.vecstore import HostTier, VectorStore
from repro_torch.models import transformer as T
from repro_torch.retrieval.knn_lm import DynamicDatastore, KNNDatastore
from repro_torch.serve.ann_engine import DynamicWorker, ShardedWorker, StaticWorker
from repro_torch.train.optimizer import AdamWState
from repro_torch.train.train_step import TrainState


def from_jax(pool_ids, pool_dists, x, device="cuda"):
    """The reference's pool and dataset (numpy arrays, or anything
    `np.array` takes) as the port's tensors: (Pool, x) on `device`."""
    dev = _device.resolve(device)
    ids = _device.put(pool_ids, torch.int32, dev)
    dists = _device.put(pool_dists, torch.float32, dev)
    return Pool(ids, dists), _device.put(x, torch.float32, dev)


def _stored(data, dev: torch.device) -> torch.Tensor:
    """Stored rows as a tensor of the same element type: fp32, int8, or
    bf16 (taken through its 16-bit pattern, so no value is rounded)."""
    a = np.asarray(data)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(dev)
    if a.dtype == np.int8:
        return torch.from_numpy(a.copy()).to(dev)
    return _device.put(a, torch.float32, dev)


def store_from_jax(data, scale=None, offset=None, device="cuda") -> VectorStore:
    """The reference's `VectorStore` (its data, scale and offset as arrays)
    as the port's, on `device`."""
    dev = _device.resolve(device)
    return VectorStore(
        _stored(data, dev),
        None if scale is None else _device.put(scale, torch.float32, dev),
        None if offset is None else _device.put(offset, torch.float32, dev),
    )


def labels_from_jax(words, labels=None, device="cuda") -> LabelStore:
    """The reference's `LabelStore` (its packed words and, for a
    single-label store, its labels) as the port's, on `device`."""
    dev = _device.resolve(device)
    return LabelStore(
        _device.put(words, torch.int32, dev),
        None if labels is None else _device.put(labels, torch.int32, dev),
    )


def _is_host(a) -> bool:
    """Whether a reference rescore operand is its host tier: an object (not
    an array, not a store) holding its rows as `data`."""
    return a is not None and not isinstance(a, tuple) and not hasattr(a, "__array__")


def _operand(a, dev: torch.device):
    """A dataset operand: an array (fp32) or a (data, scale, offset) tuple
    of a store."""
    if isinstance(a, tuple):
        return store_from_jax(*a, device=dev)
    return _device.put(a, torch.float32, dev)


def optimized_from_jax(
    *,
    x,
    graph_ids,
    entry,
    inv,
    perm,
    valid=None,
    rescore=None,
    vwords=None,
    order: str = "bfs",
    pruned: bool = False,
    device="cuda",
) -> OptimizedIndex:
    """The reference's `OptimizedIndex` as the port's, on `device`: `x` and
    `rescore` are arrays or (data, scale, offset) tuples of a store, the
    rest its permuted graph, entry, `inv` / `perm` maps, mask and label
    words as arrays."""
    dev = _device.resolve(device)
    g = _device.put(graph_ids, torch.int32, dev)
    return OptimizedIndex(
        x=_operand(x, dev),
        graph_ids=g,
        entry=_device.put(entry, torch.int32, dev),
        inv=_device.put(inv, torch.int32, dev),
        perm=_device.put(perm, torch.int32, dev),
        valid=None if valid is None else _device.put(valid, torch.bool, dev),
        rescore=None if rescore is None else _operand(rescore, dev),
        vwords=None if vwords is None else _device.put(vwords, torch.int32, dev),
        order=order,
        degree=int(g.shape[1]),
        pruned=bool(pruned),
    )


def dynamic_from_jax(
    *,
    x,
    store,
    pool_ids,
    pool_dists,
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
    """A reference `DynamicIndex`'s state as the port's index: the padded
    fp32 buffer `x`, `store` = (data, scale, offset) of its traversal tier
    or None, the pool, `valid`, `labels`, the counters, the cached `entry`
    (None = not cached), the localized rounds run so far (the round number
    the next draw is asked for) and its filter labels `vlabels` with their
    `n_labels` (None without). `cfg.tier` places the fp32 buffer: "host"
    keeps it in host memory behind a `HostTier`."""
    dev = _device.resolve(device)
    return DynamicIndex.from_state(
        x=np.asarray(x),
        store=None if store is None else store_from_jax(*store, device=dev),
        pool=Pool(np.asarray(pool_ids), np.asarray(pool_dists)),
        valid=np.asarray(valid),
        labels=np.asarray(labels),
        size=size,
        n_live=n_live,
        next_label=next_label,
        entry=None if entry is None else np.asarray(entry),
        rounds_run=rounds_run,
        vlabels=None if vlabels is None else np.asarray(vlabels),
        n_labels=n_labels,
        cfg=cfg,
        draws=draws,
        device=dev,
    )


def corpus_sharded_from_jax(index, device="cuda") -> CorpusShardedIndex:
    """The reference's `CorpusShardedIndex` as the port's, on `device`: its
    fields are read as numpy arrays (bf16 stored rows bit for bit). A
    host-placed rescore tier (not an array but an object holding its rows
    as `data`, the reference's `HostTier`) becomes the port's `HostTier`
    over the same rows."""
    dev = _device.resolve(device)

    def opt(a, dtype):
        return None if a is None else _device.put(np.asarray(a), dtype, dev)

    resc = index.rescores
    if _is_host(resc):
        rescores = HostTier(np.asarray(resc.data, np.float32))
    else:
        rescores = opt(resc, torch.float32)
    return CorpusShardedIndex(
        data=_stored(index.data, dev),
        scale=opt(index.scale, torch.float32),
        offset=opt(index.offset, torch.float32),
        graphs=_device.put(np.asarray(index.graphs), torch.int32, dev),
        row0s=_device.put(np.asarray(index.row0s), torch.int32, dev),
        valids=opt(index.valids, torch.bool),
        rescores=rescores,
        vwords=opt(index.vwords, torch.int32),
        ids_maps=opt(index.ids_maps, torch.int32),
        entry=_device.put(np.asarray(index.entry), torch.int32, dev),
        entry_row=_device.put(np.asarray(index.entry_row), torch.float32, dev),
        entry_valid=opt(index.entry_valid, torch.bool),
        entry_words=opt(index.entry_words, torch.int32),
        n=int(index.n),
    )


def static_worker_from_jax(worker, device="cuda") -> StaticWorker:
    """A reference `serve.ann_engine.StaticWorker` as the port's, on
    `device`: its traversal tier (an array or a store) and rescore tier (an
    array, a store, or its host tier, which stays a `HostTier` in host
    memory), graph, entry, tombstone mask, label words and `ids_map`, read
    as arrays; the visited-set choice carries over."""
    dev = _device.resolve(device)

    def opt(a):
        return None if a is None else np.asarray(a)

    resc = worker.rescore
    if _is_host(resc):
        resc = HostTier(np.asarray(resc.data, np.float32))
    elif resc is not None:
        resc = _operand(resc, dev)
    return StaticWorker(
        _operand(worker.x, dev),
        np.asarray(worker.graph_ids),
        entry=np.asarray(worker.entry),
        visited=worker.visited,
        visited_cap=worker.visited_cap,
        valid=opt(worker.valid),
        rescore=resc,
        labels=opt(worker.vwords),
        ids_map=opt(worker.ids_map),
        device=dev,
    )


def _dynamic_index_from_jax(idx, cfg: DynamicConfig, draws, device) -> DynamicIndex:
    """A reference `DynamicIndex` object's state as the port's index."""
    store = None
    if idx.store is not None:
        store = tuple(None if a is None else np.asarray(a) for a in idx.store)
    return dynamic_from_jax(
        x=np.asarray(idx.x),
        store=store,
        pool_ids=np.asarray(idx.pool.ids),
        pool_dists=np.asarray(idx.pool.dists),
        valid=np.asarray(idx.valid),
        labels=np.asarray(idx.labels),
        size=idx.size,
        n_live=idx.n_live,
        next_label=idx._next_label,
        entry=None if idx._entry is None else np.asarray(idx._entry),
        rounds_run=idx.rounds_run,
        vlabels=None if idx.vlabels is None else np.asarray(idx.vlabels),
        n_labels=idx.n_labels,
        cfg=cfg,
        draws=draws,
        device=device,
    )


def dynamic_worker_from_jax(
    worker, *, cfg: DynamicConfig = DynamicConfig(), draws=None, device="cuda"
) -> DynamicWorker:
    """A reference `DynamicWorker` as the port's: its index's state carried
    across by `dynamic_from_jax` (with `cfg`, the reference's config as the
    port's, and `draws` for the rounds of later inserts), its visited-set
    choice as it is."""
    port = _dynamic_index_from_jax(worker.index, cfg, draws, device)
    return DynamicWorker(port, visited=worker.visited, visited_cap=worker.visited_cap)


def sharded_worker_from_jax(worker, device="cuda") -> ShardedWorker:
    """A reference `ShardedWorker` as the port's: its index carried across
    by `corpus_sharded_from_jax`, its shards in this process (the
    reference's mesh is not carried; pass the port's `group=` to
    `ShardedWorker` to run them on ranks)."""
    return ShardedWorker(
        corpus_sharded_from_jax(worker.index, device=device),
        visited=worker.visited,
        visited_cap=worker.visited_cap,
    )


def lm_params_from_jax(params, cfg, device="cuda") -> T.LMParams:
    """The reference's LM parameter tree (`models/transformer.init_params`;
    leaves as numpy arrays or anything `np.asarray` takes) as the port's
    `LMParams` on `device`. Each segment's leading repeat axis is unstacked:
    repeat `rep` of position `pos` is layer offset + rep * unit + pos
    (`transformer.segment_layers`); a `shared_attn` position's entry is
    empty. The top-level trees (`shared_attn`, which has no repeat axis,
    `vision_proj`, the codebook tables) are carried as they are. fp32
    leaves stay fp32, bf16 leaves are carried bit for bit."""
    dev = _device.resolve(device)

    def tree(p, rep=None):
        if isinstance(p, dict):
            return {name: tree(v, rep) for name, v in p.items()}
        a = np.asarray(p)
        return _stored(a if rep is None else a[rep], dev)

    def top(name):
        return None if params.get(name) is None else tree(params[name])

    layers: list = [None] * cfg.n_layers
    for seg, seg_map in zip(params["segments"], T.segment_layers(cfg)):
        for pos_params, reps in zip(seg, seg_map):
            for rep, layer in enumerate(reps):
                layers[layer] = tree(pos_params, rep)
    return T.LMParams(
        top("embed"),
        tree(params["final_norm"]),
        layers,
        top("lm_head"),
        shared_attn=top("shared_attn"),
        codebook_embed=top("codebook_embed"),
        codebook_head=top("codebook_head"),
        vision_proj=top("vision_proj"),
    )


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        raise ValueError("bf16 leaves have no numpy dtype here: keep fp32 master weights")
    return t.detach().cpu().numpy()


def _nested(named: dict, prefix: str) -> dict:
    """The entries of `named` under `prefix` as a nested dict of tensors,
    split at the dots of their names."""
    out: dict = {}
    for name, t in named.items():
        if name.startswith(prefix):
            *path, leaf = name[len(prefix) :].split(".")
            node = out
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = t
    return out


def _stacked(trees: list[dict], stack: bool = True) -> dict:
    """Nested dicts of tensors of one structure as one of numpy arrays,
    each leaf stacked over the list on a new leading axis (with `stack`),
    or the one tree's leaves as they are."""
    def leaf(ts):
        return np.stack([_host(t) for t in ts]) if stack else _host(ts[0])

    return {name: _stacked([t[name] for t in trees], stack) if isinstance(v, dict)
            else leaf([t[name] for t in trees]) for name, v in trees[0].items()}


def lm_params_to_jax(params, cfg) -> dict:
    """The inverse of `lm_params_from_jax`: the port's `LMParams`, or any
    dict keyed by its parameter names (gradients, AdamW moments), as a
    numpy tree in the reference's structure (`models/transformer.init_params`):
    each segment position's layers stacked over its repeats, a
    `shared_attn` position's entry empty, no `lm_head` where the embedding
    is tied. Leaves keep their dtype; bf16 raises (numpy has no bf16)."""
    named = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else params
    tree = {name: _host(named[name])
            for name in ("embed", "lm_head", "codebook_embed", "codebook_head", "final_norm")
            if name in named}
    for name in ("vision_proj", "shared_attn"):
        sub = _nested(named, name + ".")
        if sub:
            tree[name] = _stacked([sub], stack=False)
    tree["segments"] = [
        [_stacked([_nested(named, f"layers.{layer}.") for layer in reps]) for reps in seg_map]
        for seg_map in T.segment_layers(cfg)
    ]
    return tree


def train_state_to_jax(state: TrainState, cfg) -> TrainState:
    """The port's `TrainState` as the reference's (a `TrainState` of numpy
    trees: `lm_params_to_jax` of the parameters and both moments, the step
    an int32 scalar), the tree a checkpoint holds."""
    opt = state.opt
    return TrainState(
        lm_params_to_jax(state.params, cfg),
        AdamWState(np.asarray(int(opt.step), dtype=np.int32), lm_params_to_jax(opt.mu, cfg),
                   lm_params_to_jax(opt.nu, cfg)),
    )


def train_state_from_jax(state, cfg, device="cuda") -> TrainState:
    """The reference's `TrainState` (or `train_state_to_jax`'s, or a
    restored checkpoint's: anything with `.params` and `.opt.{step, mu,
    nu}`, leaves as numpy arrays) as the port's, on `device`."""
    dev = _device.resolve(device)

    def named(tree) -> dict:
        return {name: p.detach() for name, p in
                lm_params_from_jax(tree, cfg, device=dev).named_parameters()}

    step = torch.tensor(int(np.asarray(state.opt.step)), dtype=torch.int32, device=dev)
    return TrainState(lm_params_from_jax(state.params, cfg, device=dev),
                      AdamWState(step, named(state.opt.mu), named(state.opt.nu)))


def knn_datastore_from_jax(store, device="cuda") -> KNNDatastore:
    """The reference's array-backed `KNNDatastore` (keys, values, graph) as
    the port's, on `device`."""
    dev = _device.resolve(device)
    return KNNDatastore(
        keys=_device.put(store.keys, torch.float32, dev),
        values=_device.put(store.values, torch.int32, dev),
        graph=_device.put(store.graph, torch.int32, dev),
    )


def dynamic_datastore_from_jax(
    ds, *, cfg: DynamicConfig = DynamicConfig(), draws=None, device="cuda", **knn_kw
) -> DynamicDatastore:
    """The reference's `DynamicDatastore` as the port's: its index carried
    across by `dynamic_from_jax` (`cfg` the reference's config as the
    port's, `draws` for later inserts), its label-indexed token table, vocab
    and k / ef / tau; `knn_kw` adds the port's own knobs (`visited=`)."""
    index = _dynamic_index_from_jax(ds.index, cfg, draws, device)
    return DynamicDatastore(
        index, np.asarray(ds._values), ds.vocab, k=ds.k, ef=ds.ef, tau=ds.tau, **knn_kw
    )
