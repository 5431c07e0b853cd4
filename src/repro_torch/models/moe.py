"""Mixture-of-Experts: fine-grained experts, shared experts, top-k routing.

A port of the JAX package's `models/moe.py`, its single-device
(non-expert-parallel) `moe_block`. Dispatch is the permute / capacity
formulation: token -> expert assignments are sorted by expert (a stable
sort), ranked within their expert's segment, capped at `_capacity` slots an
expert, written into an (E*C, D) buffer, run through the expert FFNs as
batched products over the expert axis, and combined back with the routing
weights. Assignments past capacity are dropped.

The combine sums each token's kept contributions from zero in ascending
expert order, in the activation dtype: the order in which the stable sort
hands them to the reference's scatter-add. No float atomics are used
(`index_add_` on the card is not repeatable), so two calls on the same
inputs are bitwise equal.

Inside `distributed.hints.use_hints(mesh)`, with a model axis whose size
divides `n_experts`, `moe_block` takes the expert-parallel path
(`_moe_block_ep`): each rank holds its own rows of the batch, copied across
its model group, and its `E / n_ep` experts' weights; it routes its rows
over all E experts, runs its own experts (`_permute_ffn`) and one
all-reduce over the model group sums the partial outputs. With DTensor
parameters and activations (the dry-run's) it converts to each rank's local
tensors at its entry and back at its exit (`_moe_block_ep_dtensor`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import hints as H
from repro_torch.models import layers as L


def init_moe_params(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32) -> dict:
    """The router (D, E) is fp32 whatever `dtype` the experts take."""
    d, e, de = cfg.d_model, cfg.n_experts, cfg.d_expert
    p = {
        "router": L.dense_init(gen, (d, e), dtype=torch.float32),
        "wi_gate": L.dense_init(gen, (e, d, de), in_axis=1, dtype=dtype),
        "wi_up": L.dense_init(gen, (e, d, de), in_axis=1, dtype=dtype),
        "wo": L.dense_init(gen, (e, de, d), in_axis=1, dtype=dtype),
    }
    if cfg.n_shared_experts:
        f = cfg.n_shared_experts * de
        p["shared"] = {
            "wi_gate": L.dense_init(gen, (d, f), dtype=dtype),
            "wi_up": L.dense_init(gen, (d, f), dtype=dtype),
            "wo": L.dense_init(gen, (f, d), dtype=dtype),
        }
    return p


def _capacity(cfg: ArchConfig, t: int) -> int:
    """Slots an expert for `t` tokens, rounded up to a multiple of 8."""
    c = int(cfg.moe_capacity_factor * t * cfg.top_k / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)


def route(params, cfg: ArchConfig, xt: torch.Tensor):
    """xt (T, D) -> (probs (T, E), w (T, k), idx (T, k)): fp32 router
    logits, softmax, top-k, the k weights renormalised to sum 1."""
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, w / w.sum(-1, keepdim=True).clamp_min(1e-9), idx


def _permute_ffn(cfg: ArchConfig, xt, w, idx, *, e_local: int, e_offset: int,
                 wi_gate, wi_up, wo):
    """Dispatch, compute and combine for the `e_local` experts starting at
    global id `e_offset`.

    xt (T, D); w / idx (T, k) routing weights and global expert ids. The
    assignments to other experts go to an out-of-range bucket and are
    neither kept nor dropped. Returns (the weighted sum of the local
    experts' outputs a token (T, D), the dropped share of the in-range
    assignments); the caller sums the partial outputs over the experts'
    ranks."""
    t, d = xt.shape
    k = cfg.top_k
    dev = xt.device

    flat_e = idx.reshape(t * k) - e_offset
    in_range = (flat_e >= 0) & (flat_e < e_local)
    flat_e = torch.where(in_range, flat_e, e_local)  # the out-of-range bucket
    tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    es, toks = flat_e[order], tok[order]
    pos_in = torch.arange(t * k, device=dev)
    is_start = torch.ones_like(es, dtype=torch.bool)
    is_start[1:] = es[1:] != es[:-1]
    seg0 = torch.cummax(torch.where(is_start, pos_in, 0), dim=0).values
    rank = pos_in - seg0

    c = _capacity(cfg, t)
    kept = (rank < c) & (es < e_local)
    slot = torch.where(kept, es * c + rank, e_local * c)  # row e_local * c: the spare
    buf = torch.zeros((e_local * c + 1, d), dtype=xt.dtype, device=dev)
    buf[slot] = xt[toks]

    h = buf[: e_local * c].view(e_local, c, d)
    g = F.silu(torch.bmm(h, wi_gate.to(xt.dtype)))
    u = torch.bmm(h, wi_up.to(xt.dtype))
    out_e = torch.bmm(g * u, wo.to(xt.dtype)).reshape(e_local * c, d)
    out_e = torch.cat([out_e, out_e.new_zeros((1, d))])  # an unkept assignment reads 0

    # combine: each token's k assignments in routing order
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot
    slot_of = slot_of.view(t, k)
    wk = w.to(xt.dtype)
    y = torch.zeros((t, d), dtype=xt.dtype, device=dev)
    for j in range(k):
        y = y + out_e[slot_of[:, j]] * wk[:, j, None]
    drop_frac = 1.0 - kept.float().sum() / in_range.float().sum().clamp_min(1.0)
    return y, drop_frac


class _FromModelGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group, where each rank's covers only its own experts."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ToModelGroup(torch.autograd.Function):
    """The sum over the model group forward; identity backward: the sum is
    every rank's copy of one output, not a term of a sum over ranks."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _moe_block_ep(params, cfg: ArchConfig, x: torch.Tensor, hints: H.MeshHints):
    """The expert-parallel MoE block on one rank of `hints.mesh`.

    x holds this rank's rows of the batch (its data shard), the same on
    every rank of its model group; `params` the replicated router and
    shared experts, and the expert weights of this rank's E / n_ep experts
    (`wi_gate` (E / n_ep, D, de), ...). Dispatch is a local select, the
    combine one all-reduce of the (T, D) partial output over the model
    group. As in the reference: the router product runs in the activation
    dtype, the capacity comes from the local token count, the drop
    fraction is the model group's mean, and the load-balance loss is this
    rank's, from its tokens over all E experts.

    The gradient of an expert-dependent term is each rank's own share, so
    the model group sums it where it meets the replicated part: at the
    tokens the experts read and at the routing weights. The router's
    softmax and the load-balance loss are the same on every rank of the
    group and take their gradients locally."""
    b, s, d = x.shape
    e = cfg.n_experts
    group = hints.mesh.get_group(hints.model_axis)
    n_ep = dist.get_world_size(group)
    e_loc = e // n_ep
    if params["wi_gate"].shape[0] != e_loc:
        raise ValueError(f"expert weights hold {params['wi_gate'].shape[0]} experts; "
                         f"this rank's share of {e} over {n_ep} is {e_loc}")
    e0 = dist.get_rank(group) * e_loc

    xt = x.reshape(b * s, d)
    logits = (xt @ params["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    y_part, drop = _permute_ffn(
        cfg, _FromModelGroup.apply(xt, group), _FromModelGroup.apply(w, group), idx,
        e_local=e_loc, e_offset=e0, wi_gate=params["wi_gate"], wi_up=params["wi_up"],
        wo=params["wo"])
    y = _ToModelGroup.apply(y_part, group)
    with torch.no_grad():
        drop = drop.clone()
        dist.all_reduce(drop, group=group)
        drop = drop / n_ep

    if cfg.n_shared_experts:
        sp = params["shared"]
        y = y + L.gated_mlp(xt, sp["wi_gate"], sp["wi_up"], sp["wo"])

    me = _expert_counts(idx.reshape(-1), e)
    me = me / me.sum().clamp_min(1.0)
    aux = {"moe_lb_loss": e * (me * probs.mean(0)).sum(), "moe_drop_frac": drop}
    return y.reshape(b, s, d), aux


def _expert_counts(flat_idx: torch.Tensor, e: int) -> torch.Tensor:
    """Assignments an expert, fp32 (E,): an `index_add_` of ones, exact
    below 2^24 a count (`bincount` has no `meta` kernel, which the dry-run
    traces on)."""
    ones = torch.ones(flat_idx.shape, dtype=torch.float32, device=flat_idx.device)
    return torch.zeros((e,), dtype=torch.float32, device=flat_idx.device).index_add_(
        0, flat_idx, ones)


def _items(tree):
    """(name, leaf or sub-tree) of a `ParamTree` or a dict."""
    if isinstance(tree, dict):
        return tree.items()
    return [*tree._parameters.items(), *tree._modules.items()]


def _moe_block_ep_dtensor(params, cfg: ArchConfig, x: DTensor, hints: H.MeshHints):
    """`_moe_block_ep` on DTensors: each rank's tokens (the batch over the
    data axes, whole on the model axis; whole everywhere if the batch does
    not split), its experts' weights (over the model axis) and the router
    and shared experts whole go in as local tensors, and the output comes
    back a DTensor of the token placement. The parameters' gradients are
    partial sums over the data axes (each rank's from its own tokens); the
    aux values are this rank's, taken as replicated, as the reference's
    `shard_map` returns its lb."""
    mesh = hints.mesh
    names = mesh.mesh_dim_names
    n_data = 1
    for a in hints.data_axes:
        n_data *= mesh[a].size()
    split = x.shape[0] % n_data == 0
    tok = [Shard(0) if split and n in hints.data_axes else Replicate() for n in names]
    rep = [Replicate()] * len(names)

    def local(tree):
        out = {}
        for name, v in _items(tree):
            if not isinstance(v, torch.Tensor):
                out[name] = local(v)
                continue
            expert = name in ("wi_gate", "wi_up", "wo") and v.dim() == 3
            pl = [Shard(0) if expert and n == hints.model_axis else Replicate() for n in names]
            grad_pl = [Partial() if split and n in hints.data_axes else p for n, p in zip(names, pl)]
            out[name] = v.redistribute(mesh, pl).to_local(grad_placements=grad_pl)
        return out

    y, aux = _moe_block_ep(local(params), cfg, x.redistribute(mesh, tok).to_local(), hints)
    y = DTensor.from_local(y, mesh, tok, run_check=False, shape=x.shape, stride=x.stride())
    return y, {k: DTensor.from_local(v, mesh, rep, run_check=False) for k, v in aux.items()}


def moe_block(params, cfg: ArchConfig, x: torch.Tensor):
    """x (B, S, D) -> (out (B, S, D), aux {"moe_lb_loss", "moe_drop_frac"});
    the expert-parallel path (`_moe_block_ep`) under hints that name a
    model axis whose size divides n_experts."""
    hints = H.get_hints()
    if hints is not None and hints.model_axis is not None \
            and cfg.n_experts % hints.mesh[hints.model_axis].size() == 0:
        if isinstance(x, DTensor):
            return _moe_block_ep_dtensor(params, cfg, x, hints)
        return _moe_block_ep(params, cfg, x, hints)
    if isinstance(x, DTensor):
        raise NotImplementedError(
            f"the MoE block on DTensors runs expert-parallel only: {cfg.n_experts} experts "
            "need hints whose model axis divides them")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    dev = x.device
    probs, w, idx = route(params, cfg, xt)

    # permute: sort the assignments by expert, rank each within its segment
    flat_e = idx.reshape(t * k)
    tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    es, toks = flat_e[order], tok[order]
    pos_in = torch.arange(t * k, device=dev)
    is_start = torch.ones_like(es, dtype=torch.bool)
    is_start[1:] = es[1:] != es[:-1]
    seg0 = torch.cummax(torch.where(is_start, pos_in, 0), dim=0).values
    rank = pos_in - seg0

    c = _capacity(cfg, t)
    kept = rank < c
    slot = torch.where(kept, es * c + rank, e * c)  # row e * c: the spare, dropped
    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = xt[toks]

    # the expert FFNs (SwiGLU), batched over the expert axis
    h = buf[: e * c].view(e, c, d)
    g = F.silu(torch.bmm(h, params["wi_gate"].to(x.dtype)))
    u = torch.bmm(h, params["wi_up"].to(x.dtype))
    out_e = torch.bmm(g * u, params["wo"].to(x.dtype)).reshape(e * c, d)
    out_e = torch.cat([out_e, out_e.new_zeros((1, d))])  # a dropped slot reads 0

    # combine: each token's k slots in ascending expert order, summed from 0
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot
    by_e = torch.argsort(idx, dim=1)  # a token's experts are distinct
    slot_of = slot_of.view(t, k).gather(1, by_e)
    w_e = w.gather(1, by_e).to(x.dtype)
    y = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for j in range(k):
        y = y + out_e[slot_of[:, j]] * w_e[:, j, None]

    if cfg.n_shared_experts:
        sp = params["shared"]
        y = y + L.gated_mlp(xt, sp["wi_gate"], sp["wi_up"], sp["wo"])

    # aux: the Switch-style load-balance loss and the dropped share
    me = _expert_counts(flat_e, e) / (t * k)
    pe = probs.mean(0)
    aux = {
        "moe_lb_loss": e * (me * pe).sum(),
        "moe_drop_frac": 1.0 - kept.float().mean(),
    }
    return y.reshape(b, s, d), aux
