"""Model assembly: the dense text decoder stacks (gemma2-2b, h2o-danube-1.8b,
gemma3-27b, gemma3-1b).

A port of the JAX package's `models/transformer.py` for its dense text
families. The reference scans stacked parameters over each *segment* (one
repeat of the layer pattern, `lax.scan` over the repeats); the port holds an
`nn.ModuleList` of layers in layer order, with one KV-cache entry per
layer. `layer_descs` and `build_segments` stay, so `convert` can map a
segment's (repeat, position) to its layer: layer = segment offset +
rep * unit + pos.

MoE blocks, SSM blocks, zamba2's shared attention and the audio and vision
frontends are not ported yet (ROADMAP A.5b): a config that needs one raises
`NotImplementedError`. `forward` runs without remat, and without the FSDP
gather hints of the reference (ROADMAP A.7).

Every entry point takes `params`, an `LMParams`, and the `ArchConfig`, as
the reference takes its parameter tree. Parameters are made with
`requires_grad=False` (this slice serves; training is ROADMAP A.6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for a config outside the dense text stack."""
    kinds = set(cfg.layer_kinds())
    missing = [
        what
        for what, has in (
            ("MoE blocks", bool(cfg.n_experts)),
            ("SSM blocks", "ssm" in kinds),
            ("shared attention", "shared_attn" in kinds),
            (f"the {cfg.modality} frontend", cfg.modality != "text"),
        )
        if has
    ]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} are not ported yet (ROADMAP A.5b)"
        )


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------


def layer_descs(cfg: ArchConfig) -> list[tuple[str, str]]:
    """Per-layer (kind, mlp_kind)."""
    out = []
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == "ssm":
            out.append(("ssm", "none"))
        else:
            mlp = "moe" if (cfg.n_experts and i >= cfg.first_k_dense and kind != "shared_attn") else "dense"
            out.append((kind, mlp))
    return out


def build_segments(cfg: ArchConfig) -> list[tuple[tuple, int]]:
    """The reference's segments: (per-position descriptors, repeats)."""
    descs = layer_descs(cfg)
    segments: list[tuple[tuple, int]] = []
    i = 0
    if cfg.first_k_dense:
        segments.append((tuple(descs[: cfg.first_k_dense]), 1))
        i = cfg.first_k_dense
    body = descs[i:]
    unit = len(cfg.layer_pattern)
    if unit > len(body):
        unit = max(len(body), 1)
    n_rep = len(body) // unit
    if n_rep:
        segments.append((tuple(body[:unit]), n_rep))
    tail = body[n_rep * unit :]
    if tail:
        segments.append((tuple(tail), 1))
    return segments


def segment_layers(cfg: ArchConfig) -> list[list[list[int]]]:
    """`[segment][pos][rep]` -> layer index: the segment's offset plus
    rep * unit + pos."""
    out, offset = [], 0
    for desc, n_rep in build_segments(cfg):
        unit = len(desc)
        out.append([[offset + rep * unit + pos for rep in range(n_rep)] for pos in range(unit)])
        offset += unit * n_rep
    return out


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: leaves become parameters
    (`requires_grad=False`), dicts sub-trees; `tree["name"]` reads either."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            else:
                self.register_parameter(name, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class LMParams(nn.Module):
    """The parameters of a dense text LM: the token embedding (V, D) (tied
    to the output head unless `lm_head` (D, V) is present), `final_norm`
    (D,), and `layers`, one `ParamTree` a layer in layer order, each with
    `ln1`, `attn` {wq, wk, wv, wo[, q_norm, k_norm]}, `ln2`, `mlp`
    {wi_gate, wi_up, wo} and, with post-norms, `post_ln1` / `post_ln2`."""

    def __init__(self, embed, final_norm, layers: list[dict], lm_head=None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head, requires_grad=False)
        self.layers = nn.ModuleList(ParamTree(p) for p in layers)


def _init_layer(gen: torch.Generator, cfg: ArchConfig, dtype) -> dict:
    d = cfg.d_model

    def zeros():
        return torch.zeros((d,), dtype=dtype, device=gen.device)

    p = {"ln1": zeros(), "attn": A.init_attn_params(gen, cfg, dtype), "ln2": zeros()}
    if cfg.post_norm:
        p["post_ln1"], p["post_ln2"] = zeros(), zeros()
    p["mlp"] = {
        "wi_gate": L.dense_init(gen, (d, cfg.d_ff), dtype=dtype),
        "wi_up": L.dense_init(gen, (d, cfg.d_ff), dtype=dtype),
        "wo": L.dense_init(gen, (cfg.d_ff, d), dtype=dtype),
    }
    return p


def init_params(cfg: ArchConfig, *, seed: int = 0, dtype=torch.float32, device="cuda") -> LMParams:
    """Random parameters on `device`, drawn from a `torch.Generator` seeded
    with `seed` (norm scales zero, as the reference initialises them)."""
    check_supported(cfg)
    gen = torch.Generator(_device.resolve(device)).manual_seed(seed)
    embed = L.dense_init(gen, (cfg.vocab, cfg.d_model), in_axis=1, dtype=dtype)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = L.dense_init(gen, (cfg.d_model, cfg.vocab), dtype=dtype)
    layers = [_init_layer(gen, cfg, dtype) for _ in range(cfg.n_layers)]
    final_norm = torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device)
    return LMParams(embed, final_norm, layers, lm_head)


# ---------------------------------------------------------------------------
# per-layer apply
# ---------------------------------------------------------------------------


def _mlp_and_norms(lp, cfg: ArchConfig, x, attn_out):
    if cfg.post_norm:
        attn_out = L.rms_norm(attn_out, lp["post_ln1"], cfg.norm_eps)
    x = x + attn_out
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    mlp = lp["mlp"]
    mlp_out = L.gated_mlp(h, mlp["wi_gate"], mlp["wi_up"], mlp["wo"])
    if cfg.post_norm:
        mlp_out = L.rms_norm(mlp_out, lp["post_ln2"], cfg.norm_eps)
    return x + mlp_out


def _apply_layer(lp, cfg: ArchConfig, kind: str, x, positions):
    """Full-sequence layer. Returns (x, {"k", "v"})."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn_out, (k, v) = A.attention_block(lp["attn"], cfg, h, positions, kind=kind)
    return _mlp_and_norms(lp, cfg, x, attn_out), {"k": k, "v": v}


def _apply_layer_decode(lp, cfg: ArchConfig, kind: str, x1, cache, pos):
    """Single-token layer; `cache` is written in place."""
    h = L.rms_norm(x1, lp["ln1"], cfg.norm_eps)
    attn_out, cache = A.attention_decode_block(lp["attn"], cfg, h, cache, pos, kind=kind)
    return _mlp_and_norms(lp, cfg, x1, attn_out), cache


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def embed_inputs(params: LMParams, cfg: ArchConfig, batch, act_dtype=torch.bfloat16):
    """batch {"tokens": (B, S)} -> (x (B, S, D), positions (S,)).

    The rows are gathered before the cast to `act_dtype` (the same values
    as casting the table first); `embed_scale` multiplies by sqrt(d_model)
    cast to the activation dtype."""
    check_supported(cfg)
    tokens = batch["tokens"].to(params.embed.device).long()
    x = params.embed[tokens].to(act_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=act_dtype, device=x.device)
    return x, torch.arange(x.shape[1], device=x.device)


def lm_logits(params: LMParams, cfg: ArchConfig, x) -> torch.Tensor:
    """(..., D) hidden -> (..., V) fp32 logits: the tied embedding (or
    `lm_head`), then the final softcap."""
    x32 = x.float()
    if cfg.tie_embeddings:
        logits = x32 @ params.embed.float().T
    else:
        logits = x32 @ params.lm_head.float()
    return L.softcap(logits, cfg.logit_softcap)


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


def forward(params: LMParams, cfg: ArchConfig, batch, *, act_dtype=torch.bfloat16,
            return_cache: bool = False, return_hidden: bool = False):
    """Full-sequence forward. Returns (logits | hidden, aux[, caches]).

    `hidden` is the post-`final_norm` state (B, S, D); `aux` the scalar
    auxiliary loss (zero: no MoE block here); `caches` one {"k", "v"} of
    (B, S, K, Dh) a layer."""
    x, positions = embed_inputs(params, cfg, batch, act_dtype)
    bpos = positions[None, :].expand(x.shape[0], -1)
    caches = []
    for lp, (kind, _) in zip(params.layers, layer_descs(cfg)):
        x, entry = _apply_layer(lp, cfg, kind, x, bpos)
        if return_cache:
            caches.append(entry)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    out = x if return_hidden else lm_logits(params, cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_cache:
        return out, aux, caches
    return out, aux


def make_cache(cfg: ArchConfig, batch_size: int, s_max: int, dtype=torch.bfloat16,
               device="cuda") -> list[dict]:
    """An empty KV cache: one {"k", "v"} of (B, s_max, K, Dh) a layer."""
    check_supported(cfg)
    dev = _device.resolve(device)
    shape = (batch_size, s_max, cfg.n_kv_heads, cfg.head_dim)
    return [
        {"k": torch.zeros(shape, dtype=dtype, device=dev), "v": torch.zeros(shape, dtype=dtype, device=dev)}
        for _ in range(cfg.n_layers)
    ]


def prefill(params: LMParams, cfg: ArchConfig, batch, s_max: int | None = None,
            act_dtype=torch.bfloat16, return_hidden: bool = False):
    """Process the prompt; returns (last-position logits (B, V), caches,
    prompt length), and with `return_hidden=True` also the post-`final_norm`
    hidden state of the last prompt position (B, D), the retrieval query of
    the first generated token. Only the last position's logits are
    computed; the caches are zero-padded to `s_max` slots."""
    hidden, _, caches = forward(params, cfg, batch, act_dtype=act_dtype, return_cache=True,
                                return_hidden=True)
    logits = lm_logits(params, cfg, hidden[:, -1:])
    s = hidden.shape[1]
    if s_max is not None and s_max > s:
        pad = (0, 0, 0, 0, 0, s_max - s)
        caches = [{"k": F.pad(c["k"], pad), "v": F.pad(c["v"], pad)} for c in caches]
    if return_hidden:
        return logits[:, -1], caches, s, hidden[:, -1]
    return logits[:, -1], caches, s


def decode_step(params: LMParams, cfg: ArchConfig, caches, tokens, pos,
                act_dtype=torch.bfloat16, return_hidden: bool = False):
    """One decode step for every sequence: tokens (B,) at positions pos (B,).

    The caches are updated in place (the reference donates them). Returns
    (logits (B, V), caches), and with `return_hidden=True` also the
    post-`final_norm` hidden state (B, D) the logits were read from."""
    x, _ = embed_inputs(params, cfg, {"tokens": tokens[:, None]}, act_dtype)
    pos = pos.to(x.device)
    for lp, (kind, _), cache in zip(params.layers, layer_descs(cfg), caches):
        x, _ = _apply_layer_decode(lp, cfg, kind, x, cache, pos)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = lm_logits(params, cfg, x)
    if return_hidden:
        return logits[:, 0], caches, x[:, 0]
    return logits[:, 0], caches
