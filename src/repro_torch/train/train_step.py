"""Loss and train step: next-token cross-entropy over sequence chunks,
microbatch gradient accumulation, the MoE load-balance loss folded in.

A port of the JAX package's `train/train_step.py`. The reference `jit`s
the step; here it runs eagerly, one autograd pass a microbatch. With
`compress_pod_grads` the gradients are averaged over the ranks of the pod
group through the int8 `distributed.compression.compressed_psum_mean`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.compression import compressed_psum_mean
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O


def _chunk_nll(params, cfg: ArchConfig, hidden, targets) -> torch.Tensor:
    """The summed NLL of one chunk: fp32 logits, log-softmax, each target's
    entry taken by indexing (whose backward has a deterministic CUDA
    path), targets of -1 masked out."""
    logits = T.lm_logits(params, cfg, hidden)
    lp = SH.reshape(torch.log_softmax(logits, dim=-1), -1, logits.shape[-1])
    t = SH.reshape(targets, -1).long()
    if isinstance(lp, DTensor):
        return _picked_nll_sharded(lp, t)
    nll = -lp[torch.arange(t.shape[0], device=t.device), t.clamp_min(0)]
    return torch.where(t >= 0, nll, 0.0).sum()


def _picked_nll_sharded(lp: DTensor, t) -> DTensor:
    """`_chunk_nll`'s sum on DTensors, each rank over its own rows (DTensor's
    rule for the row-and-column index would gather every rank's rows of
    `lp` first): `lp` (N, V) and the targets (N,) go to one row sharding,
    over every mesh dim either splits its rows over, and the local sums
    come back as a partial sum over those mesh dims. (`lp` is whole along
    the vocabulary: the log-softmax needs it so.)"""
    mesh = lp.device_mesh
    t = SH.as_dtensor(t, mesh)

    def split(p):
        return isinstance(p, Shard) and p.dim == 0

    rows = [Shard(0) if split(a) or split(b) else Replicate()
            for a, b in zip(lp.placements, t.placements)]
    t_l = t.redistribute(mesh, rows).to_local()
    lp_l = lp.redistribute(mesh, rows).to_local()
    nll = -lp_l[torch.arange(t_l.shape[0], device=t_l.device), t_l.clamp_min(0)]
    nll = torch.where(t_l >= 0, nll, 0.0).sum()
    return DTensor.from_local(nll, mesh, [Partial() if isinstance(p, Shard) else p for p in rows],
                              run_check=False)


def _ce_from_hidden(params, cfg: ArchConfig, hidden, targets, chunk: int = 512):
    """Sequence-chunked cross-entropy, the mean over targets >= 0.

    Each `chunk` positions of the sequence axis take their fp32 logits
    under `torch.utils.checkpoint`, which the backward recomputes, so no
    (B, S, V) tensor exists (8 x 512 x 262,144 fp32 is 4.3 GB at gemma3's
    vocab). hidden (B, S, D); targets (B, S), or (B, S, ncb) for the audio
    heads."""
    s = hidden.shape[1]
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, chunk):
        total = total + _ckpt.checkpoint(_chunk_nll, params, cfg, hidden[:, lo : lo + chunk],
                                         targets[:, lo : lo + chunk], use_reentrant=False)
    denom = torch.clamp((targets >= 0).float().sum(), min=1.0)
    return total / denom


def loss_fn(params: T.LMParams, cfg: ArchConfig, batch, *, aux_weight: float = 0.01,
            act_dtype=torch.bfloat16, remat: bool = True, ce_chunk: int = 512,
            remat_policy: str = "full"):
    """Next-token cross-entropy (the mean over predicted positions) plus
    `aux_weight` x the MoE layers' summed load-balance loss. Vision
    positions predict nothing. Returns (loss, {"ce", "moe_aux"})."""
    hidden, aux = T.forward(params, cfg, batch, act_dtype=act_dtype, remat=remat,
                            return_hidden=True, remat_policy=remat_policy)
    toks = batch["tokens"].to(hidden.device)
    if cfg.modality == "vision_text":
        hidden = hidden[:, cfg.vision_tokens :]
    ce = _ce_from_hidden(params, cfg, hidden[:, :-1], toks[:, 1:], chunk=ce_chunk)
    return ce + aux_weight * aux, {"ce": ce, "moe_aux": aux}


def loss_and_grads(params: T.LMParams, cfg: ArchConfig, batch, **loss_kw):
    """(loss, aux, gradients by parameter name) of `loss_fn(params, cfg,
    batch, **loss_kw)`. The parameters take gradients only for the call
    (`requires_grad_` on, then off), so a model serves as it is between
    steps; a parameter the loss does not reach gets zeros, as under
    `jax.grad`."""
    named = dict(params.named_parameters())
    params.requires_grad_(True)
    try:
        loss, aux = loss_fn(params, cfg, batch, **loss_kw)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    finally:
        params.requires_grad_(False)
    grads = {name: torch.zeros_like(p) if g is None else g
             for (name, p), g in zip(named.items(), grads)}
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


class TrainState(NamedTuple):
    params: T.LMParams
    opt: O.AdamWState


def _split(batch: dict, n: int, i: int) -> dict:
    """Microbatch i of n: rows [i * b / n, (i + 1) * b / n) of every entry."""
    out = {}
    for name, x in batch.items():
        m = x.shape[0] // n
        out[name] = x[i * m : (i + 1) * m]
    return out


def make_train_step(cfg: ArchConfig, opt_cfg: O.AdamWConfig, *, microbatches: int = 1,
                    aux_weight: float = 0.01, act_dtype=torch.bfloat16,
                    compress_pod_grads: bool = False, pod_axis=None, ce_chunk: int = 512,
                    remat_policy: str = "full"):
    """`train_step(state, batch) -> (state, metrics)`.

    `microbatches > 1` splits the batch's rows and accumulates the
    gradients in fp32, divided by the count; the loss is the microbatches'
    mean and the aux metrics the last one's. With `compress_pod_grads` and
    `pod_axis` (a process group: the pod group of a mesh,
    `mesh.get_group("pod")`) both set, the accumulated gradients are
    replaced by their int8-compressed mean over that group before AdamW;
    every rank of the group must step together. The parameters take
    gradients only while the step computes them (`loss_and_grads`), and
    AdamW updates them in place. metrics: loss, ce, moe_aux, grad_norm, lr
    (tensors on the parameters' device; the loss is this rank's)."""
    loss_kw = dict(aux_weight=aux_weight, act_dtype=act_dtype, ce_chunk=ce_chunk,
                   remat_policy=remat_policy)

    def train_step(state: TrainState, batch):
        params = state.params
        if microbatches > 1:
            loss = torch.zeros((), dtype=torch.float32, device=params.device)
            grads = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for name, p in params.named_parameters()}
            for i in range(microbatches):
                mb_loss, aux, mb_grads = loss_and_grads(params, cfg, _split(batch, microbatches, i),
                                                        **loss_kw)
                loss = loss + mb_loss
                grads = {name: g + mb_grads[name] for name, g in grads.items()}
            loss = loss / microbatches
            grads = {name: g / microbatches for name, g in grads.items()}
        else:
            loss, aux, grads = loss_and_grads(params, cfg, batch, **loss_kw)
        if compress_pod_grads and pod_axis is not None:
            grads = {name: compressed_psum_mean(g, pod_axis) for name, g in grads.items()}
        _, opt, om = O.apply(opt_cfg, state.opt, dict(params.named_parameters()), grads)
        return TrainState(params, opt), {"loss": loss, **aux, **om}

    return train_step
