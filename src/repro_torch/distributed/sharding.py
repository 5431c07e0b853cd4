"""Sharding rules: parameter, optimizer-state, batch and cache specs for
the production mesh, with divisibility-aware fallbacks.

A port of the JAX package's `distributed/sharding.py`. The rules take the
mesh's axis sizes (a `{name: size}` mapping; `axis_sizes` reads one off a
`DeviceMesh`) and return one spec a leaf: a tuple laid out as a
`PartitionSpec` is, one entry a tensor dimension (an axis name, a tuple of
names, or None), the empty tuple where the leaf replicates. So the rules
need no process group; `placements` turns a spec into DTensor placements
for a real `DeviceMesh`.

Policy (DP over pod + data, TP / EP over model):
  * parameters replicate over (pod, data); their widest TP-able dim shards
    over "model": attention heads, MLP hidden, experts, vocab; norms
    replicate;
  * the reference stacks a segment's layers under a leading repeat axis
    that never shards (`stacked=True`); the port's parameters are per
    layer (`layers.{i}.attn.wq`), so its rules run with `stacked=False`
    and give the reference's spec with that axis dropped;
  * batches shard dim 0 over (pod, data);
  * KV caches shard batch -> data axes, then kv heads -> model when
    divisible, else the sequence dim -> model (gemma3-1b's single KV head,
    or one long sequence).

Every rule is a request: `_ok` guards divisibility, so any architecture
fits any mesh, falling back to replication instead of raising.
"""

from __future__ import annotations

from typing import Mapping

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.train.optimizer import AdamWState

Spec = tuple


def axis_sizes(mesh: DeviceMesh) -> dict[str, int]:
    """{axis name: ranks along it} of a `DeviceMesh`."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axsize(sizes: Mapping[str, int], ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        out = 1
        for a in ax:
            out *= sizes[a]
        return out
    return sizes[ax]


def _ok(dim: int, sizes: Mapping[str, int], ax) -> bool:
    s = _axsize(sizes, ax)
    return s > 1 and dim % s == 0 and dim >= s


def data_axes(sizes: Mapping[str, int]) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in sizes else ("data",)


def _param_spec(path: str, shape: tuple[int, ...], sizes: Mapping[str, int],
                stacked: bool) -> Spec:
    """The TP spec of one parameter leaf, by its dotted name and shape."""
    dims: list = [None] * len(shape)
    off = 1 if stacked else 0  # the reference's leading stack axis never shards

    def try_shard(rel_axis: int) -> bool:
        i = off + rel_axis
        if i < len(shape) and _ok(shape[i], sizes, "model"):
            dims[i] = "model"
            return True
        return False

    name = path.split(".")[-1]
    if name in ("wq", "wk", "wv"):      # (D, H, Dh) / (D, K, Dh)
        _ = try_shard(1) or try_shard(2) or try_shard(0)
    elif name == "wo" and "attn" in path:   # (H, Dh, D)
        _ = try_shard(0) or try_shard(2)
    elif name in ("wi_gate", "wi_up"):  # (D, F) or (E, D, de)
        _ = try_shard(len(shape) - off - 1) if len(shape) - off == 2 else try_shard(0)
        if dims.count("model") == 0 and len(shape) - off == 3:
            _ = try_shard(2)
    elif name == "wo":                  # mlp (F, D) / moe (E, de, d)
        _ = try_shard(0)
    elif name == "router":              # (D, E)
        _ = try_shard(1)
    elif name in ("embed", "lm_head", "codebook_embed", "codebook_head"):
        vdim = {"embed": 0, "lm_head": 1, "codebook_embed": 1, "codebook_head": 2}[name]
        _ = try_shard(vdim)             # the vocab dim
    elif name == "in_proj":             # ssm (D, P)
        _ = try_shard(1) or try_shard(0)
    elif name == "out_proj":            # ssm (di, D)
        _ = try_shard(0) or try_shard(1)
    elif name in ("w1", "w2"):          # vision projector
        _ = try_shard(1)
    # everything else (norms, conv, scalars) replicates
    return tuple(dims)


def _extend_fsdp(spec: Spec, shape, sizes: Mapping[str, int], stacked: bool) -> Spec:
    """ZeRO / FSDP: also shard the largest free dim over the data axes."""
    daxes = data_axes(sizes)
    dims = list(spec) + [None] * (len(shape) - len(spec))
    best, best_size = None, 0
    for i, d in enumerate(dims):
        if d is not None or (stacked and i == 0):
            continue
        if _ok(shape[i], sizes, daxes) and shape[i] > best_size:
            best, best_size = i, shape[i]
    if best is not None:
        dims[best] = daxes
    return tuple(dims)


def _leaf_spec(name: str, shape, sizes, tp: bool, fsdp: bool) -> Spec:
    if not tp:
        return ()
    spec = _param_spec(name, shape, sizes, stacked=False)
    return _extend_fsdp(spec, shape, sizes, stacked=False) if fsdp else spec


def param_shardings(sizes: Mapping[str, int], params, tp: bool = True,
                    fsdp: bool = False) -> dict[str, Spec]:
    """{parameter name: spec} of `LMParams` (on any device: "meta" gives
    the shapes alone). `tp=False` replicates every parameter (the dp_only
    policy); `fsdp=True` also shards over the data axes."""
    return {name: _leaf_spec(name, tuple(p.shape), sizes, tp, fsdp)
            for name, p in params.named_parameters()}


def opt_state_shardings(sizes: Mapping[str, int], state: AdamWState, tp: bool = True,
                        fsdp: bool = False) -> AdamWState:
    """An `AdamWState` of specs: the step replicates, mu / nu follow the
    parameter rules."""
    def moments(tree):
        return {name: () if m.dim() == 0 else _leaf_spec(name, tuple(m.shape), sizes, tp, fsdp)
                for name, m in tree.items()}

    return AdamWState((), moments(state.mu), moments(state.nu))


def batch_shardings(sizes: Mapping[str, int], batch: Mapping,
                    batch_axes: tuple[str, ...] | None = None) -> dict[str, Spec]:
    """Token / patch batches: dim 0 (the batch) over (pod, data), or over
    `batch_axes` (e.g. with "model" under the dp_only policy); else over
    "data" alone; else replicated."""
    daxes = batch_axes if batch_axes is not None else data_axes(sizes)

    def rule(shape):
        if len(shape) >= 1 and _ok(shape[0], sizes, daxes):
            return (daxes,)
        if len(shape) >= 1 and _ok(shape[0], sizes, "data"):
            return ("data",)
        return ()

    return {name: rule(tuple(leaf.shape)) for name, leaf in batch.items()}


def _cache_spec(name: str, shape, sizes: Mapping[str, int], stacked: bool) -> Spec:
    """One cache leaf: kv (B, S, K, Dh), ssm h (B, nh, hd, st), conv
    (B, W, C), each after a leading repeat axis when `stacked`."""
    off = 1 if stacked else 0
    daxes = data_axes(sizes)
    dims: list = [None] * len(shape)
    if len(shape) >= off + 1:
        if _ok(shape[off], sizes, daxes):
            dims[off] = daxes
        elif _ok(shape[off], sizes, "data"):
            dims[off] = "data"
    if name in ("k", "v") and len(shape) == off + 4:
        if _ok(shape[off + 2], sizes, "model"):
            dims[off + 2] = "model"     # kv heads
        elif _ok(shape[off + 1], sizes, "model"):
            dims[off + 1] = "model"     # sequence (small kv / long context)
    elif name == "h" and len(shape) == off + 4:
        if _ok(shape[off + 1], sizes, "model"):
            dims[off + 1] = "model"     # ssm heads
    elif name == "conv" and len(shape) == off + 3:
        if _ok(shape[off + 2], sizes, "model"):
            dims[off + 2] = "model"     # conv channels
    return tuple(dims)


def cache_shardings(sizes: Mapping[str, int], caches: list) -> list[dict[str, Spec]]:
    """The specs of `transformer.make_cache`'s caches, one dict a layer."""
    return [{name: _cache_spec(name, tuple(leaf.shape), sizes, stacked=False)
             for name, leaf in layer.items()} for layer in caches]


def logits_sharding(sizes: Mapping[str, int], batched: bool = True) -> Spec:
    return (data_axes(sizes) if batched else None,)


def placements(spec: Spec, mesh: DeviceMesh) -> list:
    """DTensor placements of `spec` on `mesh`: `Shard(d)` on each mesh
    dimension that spec entry d names, `Replicate()` on the others. A
    tuple of names shards dim d over those mesh dimensions, major first,
    as `PartitionSpec` does."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in entry if isinstance(entry, tuple) else (entry,):
            i = names.index(ax)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {ax!r} shards two dims of {spec}")
            out[i] = Shard(d)
    return out
