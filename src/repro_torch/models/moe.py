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

The reference's expert-parallel path (`_permute_ffn`, `_moe_block_ep`, a
`shard_map` over the model axis) is not ported here (ROADMAP A.7).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
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


def moe_block(params, cfg: ArchConfig, x: torch.Tensor):
    """x (B, S, D) -> (out (B, S, D), aux {"moe_lb_loss", "moe_drop_frac"})."""
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
    me = torch.bincount(flat_e, minlength=e).float() / (t * k)
    pe = probs.mean(0)
    aux = {
        "moe_lb_loss": e * (me * pe).sum(),
        "moe_drop_frac": 1.0 - kept.float().mean(),
    }
    return y.reshape(b, s, d), aux
