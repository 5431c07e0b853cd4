"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule with linear warmup.

A port of the JAX package's `train/optimizer.py`, with its arithmetic as
written: clip by the global norm first, then `step + 1`, the bias
corrections, and `p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)` in fp32,
cast back to the parameter's dtype. (`torch.optim.AdamW` places eps and
orders its operations otherwise.)

Parameters, gradients and moments are dicts of tensors keyed by the
parameter names of `named_parameters()`; `apply` writes the new parameter
values into the tensors of `params` in place and returns new moments. The
moments start as zeros of each parameter's dtype and are fp32 after the
first update, as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: dict
    nu: dict


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def init(params: dict) -> AdamWState:
    """Step 0 and zero moments, each of its parameter's shape and dtype."""
    dev = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu={name: torch.zeros_like(p) for name, p in params.items()},
        nu={name: torch.zeros_like(p) for name, p in params.items()},
    )


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (a tensor), fp32: linear warmup to
    `lr`, then a cosine decay to `min_lr_frac * lr` at `total_steps`."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of their fp32 squares' sums."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in tree.values()))


def _to_placements(g, like):
    if isinstance(g, DTensor) and isinstance(like, DTensor) and g.placements != like.placements:
        return g.redistribute(like.device_mesh, like.placements)
    return g


@torch.no_grad()
def apply(cfg: AdamWConfig, state: AdamWState, params: dict, grads: dict):
    """One AdamW update of `params` (written in place). Returns (params,
    new state, metrics {"grad_norm" (before clipping), "lr"}).

    DTensor gradients are first brought to their moments' placements: the
    one reduction of a partial sum (an all-reduce, or a reduce-scatter
    where the moments shard over the data axes as ZeRO-1 and FSDP place
    them), where each later use would reduce again."""
    grads = {name: _to_placements(g, state.mu[name]) for name, g in grads.items()}
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    mu, nu = {}, {}
    for name, p in params.items():
        g = grads[name].float() * scale
        m = cfg.b1 * state.mu[name] + (1 - cfg.b1) * g
        v = cfg.b2 * state.nu[name] + (1 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        p32 = p.float()
        p_new = p32 - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32)
        p.copy_(p_new.to(p.dtype))
        mu[name], nu[name] = m, v
    return params, AdamWState(step, mu, nu), {"grad_norm": gnorm, "lr": lr}
