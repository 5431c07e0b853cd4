"""Sharding rules: parameter, optimizer-state, batch and cache specs for
the production mesh, with divisibility-aware fallbacks.

A port of the JAX package's `distributed/sharding.py`. The rules take the
mesh's axis sizes (a `{name: size}` mapping; `axis_sizes` reads one off a
`DeviceMesh`) and return one spec a leaf: a tuple laid out as a
`PartitionSpec` is, one entry a tensor dimension (an axis name, a tuple of
names, or None), the empty tuple where the leaf replicates. So the rules
need no process group; `placements` turns a spec into DTensor placements
for a real `DeviceMesh`, and `with_shardings` (the reference's
`with_shardings`) places a whole tree of tensors by its specs as DTensors.

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

import math
from typing import Mapping

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

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


def block_offsets(shape, pl: list, mesh: DeviceMesh) -> dict[int, tuple[int, int]]:
    """{tensor dim: (offset, size)} of this rank's block of a `shape` tensor
    under placements `pl`, for each dim they shard: a dim sharded over
    several mesh dimensions splits into their product of equal blocks,
    major first."""
    coord = mesh.get_coordinate()
    blocks: dict[int, tuple[int, int]] = {}  # tensor dim -> (block index, blocks)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            idx, n = blocks.get(p.dim, (0, 1))
            blocks[p.dim] = (idx * mesh.size(i) + coord[i], n * mesh.size(i))
    out = {}
    for d, (idx, n) in blocks.items():
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split into {n} blocks")
        size = shape[d] // n
        out[d] = (idx * size, size)
    return out


def _local_shard(t: torch.Tensor, pl: list, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of the global `t` under placements `pl`, in a
    storage of its own where it is a part (a `meta` tensor gives a `meta`
    block)."""
    blocks = block_offsets(t.shape, pl, mesh)
    for d, (off, size) in blocks.items():
        t = t.narrow(d, off, size)
    return t.clone(memory_format=torch.contiguous_format) if blocks else t


def _place(t: torch.Tensor, spec: Spec, mesh: DeviceMesh) -> DTensor:
    pl = placements(spec, mesh)
    return DTensor.from_local(_local_shard(t, pl, mesh), mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def with_shardings(tree, specs, mesh: DeviceMesh):
    """`tree` with each tensor leaf made a DTensor on `mesh` by its spec in
    `specs` (the same structure: an `nn.Module`'s specs keyed by parameter
    name, as `param_shardings` gives them; dicts, lists and named tuples
    leaf for leaf). Each rank keeps its own block of the leaf, cut by
    `DTensor.from_local` with the global shape and stride, so `meta` leaves
    stay unallocated. A module's parameters are replaced in place (they
    keep `requires_grad`), and the module is returned."""
    if isinstance(tree, nn.Module):
        for name, spec in specs.items():
            owner, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(owner)
            p = getattr(mod, leaf)
            mod.register_parameter(leaf, nn.Parameter(_place(p.detach(), spec, mesh),
                                                      requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, torch.Tensor):
        return _place(tree, specs, mesh)
    if isinstance(tree, dict):
        return {k: with_shardings(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(with_shardings(v, s, mesh) for v, s in zip(tree, specs)))
    return [with_shardings(v, s, mesh) for v, s in zip(tree, specs)]


def local_bytes(tree) -> int:
    """The bytes this rank holds of a tree of tensors and DTensors (a
    module's parameters; dicts, lists, tuples): a DTensor counts its local
    block, a storage shared by several leaves once."""
    seen: set = set()
    total = 0

    def walk(t):
        nonlocal total
        if isinstance(t, nn.Module):
            for p in t.parameters():
                walk(p)
        elif isinstance(t, torch.Tensor):
            loc = t.to_local() if isinstance(t, DTensor) else t
            st = loc.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    walk(tree)
    return total


def as_dtensor(t, mesh: DeviceMesh) -> DTensor:
    """`t` itself if it is a DTensor, else `t` replicated on `mesh` (the
    same on every rank, as a tensor made from shapes is)."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _shards(x: DTensor) -> dict[int, int]:
    """{tensor dim: the number of blocks it is split into} of a DTensor."""
    out: dict[int, int] = {}
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            out[p.dim] = out.get(p.dim, 1) * x.device_mesh.size(i)
    return out


def _replicate_dims(x: DTensor, dims) -> DTensor:
    """`x` with every mesh dimension that shards one of `dims` replicated."""
    pl = [Replicate() if isinstance(p, Shard) and p.dim in dims else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


def _view_groups(src, dst) -> list[tuple[list[int], list[int]]]:
    """The runs of input and output dims a reshape from `src` to `dst` maps
    onto each other (equal products)."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        gi, gj, pi, pj = [], [], 1, 1
        if i < len(src):
            gi, pi, i = [i], src[i], i + 1
        if j < len(dst):
            gj, pj, j = [j], dst[j], j + 1
        while pi != pj:
            if pi < pj:
                gi.append(i)
                pi, i = pi * src[i], i + 1
            else:
                gj.append(j)
                pj, j = pj * dst[j], j + 1
        groups.append((gi, gj))
    return groups


def reshape(x, *shape):
    """`x.reshape(*shape)`; on a DTensor, first replicated along any mesh
    dimension whose split the view could not keep: a merged dim sharded
    behind another of its run, a dim split unevenly, or a split whose first
    part does not divide into the blocks; the backward reshapes its
    gradient back the same way. (Some PyTorch versions refuse such views
    on DTensors rather than redistribute.)"""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
        shape = tuple(shape[0])
    return _Reshape.apply(x, tuple(shape))


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _reshape_dtensor(x, shape)

    @staticmethod
    def backward(ctx, grad):
        return reshape(grad, ctx.shape), None


def _reshape_dtensor(x: DTensor, shape: tuple) -> DTensor:
    n = math.prod(x.shape)
    if -1 in shape:
        known = math.prod(v for v in shape if v != -1)
        shape = tuple(n // known if v == -1 else v for v in shape)
    blocks = _shards(x)
    bad = set()
    for gi, gj in _view_groups(tuple(x.shape), tuple(shape)):
        ins = [d for d in gi if x.shape[d] != 1]
        outs = [d for d in gj if shape[d] != 1]
        if len(ins) <= 1 and len(outs) <= 1:
            continue
        for k, d in enumerate(ins):
            if d not in blocks:
                continue
            keep = k == 0 and x.shape[d] % blocks[d] == 0 and (
                len(outs) <= 1 or shape[outs[0]] % blocks[d] == 0) and (
                len(ins) == 1 or len(outs) <= 1)
            if not keep:
                bad.add(d)
    return _replicate_dims(x, bad).reshape(shape)


def einsum(eq: str, a, b):
    """`torch.einsum(eq, a, b)`; with a DTensor operand, as one batched
    product of the operands permuted and reshaped through `reshape` (each
    run of batch, kept and summed dims with its sharded dim first), so no
    view DTensor cannot split is asked of it."""
    if not isinstance(a, DTensor) and not isinstance(b, DTensor):
        return torch.einsum(eq, a, b)
    mesh = (a if isinstance(a, DTensor) else b).device_mesh
    a, b = as_dtensor(a, mesh), as_dtensor(b, mesh)
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    if "..." in la:  # the left operand's leading dims, as letters the equation leaves free
        free = "".join(c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in eq)
        ell = free[: a.ndim - len(la) + 3]
        la, out = la.replace("...", ell), out.replace("...", ell)
    size = {**dict(zip(la, a.shape)), **dict(zip(lb, b.shape))}
    sharded = {la[d] for d in _shards(a)} | {lb[d] for d in _shards(b)}

    def run(labels):
        return sorted(labels, key=lambda c: c not in sharded)

    batch = run([c for c in out if c in la and c in lb])
    left = run([c for c in out if c in la and c not in lb])
    right = run([c for c in out if c in lb and c not in la])
    summed = run([c for c in la if c in lb and c not in out])
    if sorted(la) != sorted(batch + left + summed) or sorted(lb) != sorted(batch + summed + right):
        raise ValueError(f"einsum {eq!r}: a label summed within one operand")

    def n(labels):
        return math.prod(size[c] for c in labels)

    lhs = reshape(a.permute([la.index(c) for c in batch + left + summed]),
                  n(batch), n(left), n(summed))
    rhs = reshape(b.permute([lb.index(c) for c in batch + summed + right]),
                  n(batch), n(summed), n(right))
    order = batch + left + right
    prod = reshape(torch.bmm(lhs, rhs), [size[c] for c in order])
    return prod.permute([order.index(c) for c in out])


def matmul(x, w):
    """`x @ w` for x (..., K) and w (K, N); with a DTensor operand, one 2-D
    product between two `reshape`s (matmul folds x's leading dims by a view,
    whose backward some PyTorch versions refuse on a DTensor gradient)."""
    if (not isinstance(x, DTensor) and not isinstance(w, DTensor)) or x.ndim <= 2:
        return x @ w
    return reshape(reshape(x, -1, x.shape[-1]) @ w, *x.shape[:-1], w.shape[-1])


def local_along(fn, x, dim: int):
    """`fn(x)` for an `fn` that works along `dim` alone and keeps the shape
    (a cumulative sum); on a DTensor, on each rank's block, `dim` whole.
    (DTensor has no rule for `flip`, which a cumulative sum's backward
    runs, in some PyTorch versions.)"""
    if not isinstance(x, DTensor):
        return fn(x)
    x = _replicate_dims(x, {dim % x.ndim})
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())
