"""Model assembly: config-driven decoder stacks for all ten configs: the
dense text families, MoE (deepseek-moe-16b, qwen3-moe-235b-a22b), Mamba2
(mamba2-130m), the Mamba2 + shared-attention hybrid (zamba2-7b), and the
audio (musicgen-large) and vision (internvl2-2b) frontends.

A port of the JAX package's `models/transformer.py`. The reference scans
stacked parameters over each *segment* (one repeat of the layer pattern,
`lax.scan` over the repeats); the port holds an `nn.ModuleList` of layers in
layer order, with one cache entry per layer. `layer_descs` and
`build_segments` stay, so `convert` can map a segment's (repeat, position)
to its layer: layer = segment offset + rep * unit + pos.

Zamba2's shared attention block has ONE parameter set (`LMParams.shared_attn`)
applied at every `shared_attn` position, whose own layer entry is empty;
each occurrence keeps its own KV cache. The audio frontend sums the
codebook embeddings of a (B, S, ncb) token grid and reads one head a
codebook; the vision frontend projects precomputed patch embeddings into
the positions before the text. `forward` remats each layer under
`torch.utils.checkpoint` while gradients are on (the reference remats each
repeat of a segment). Under `distributed.hints.use_hints(mesh, fsdp=True)`,
with DTensor parameters sharded over the data axes too (the FSDP policy's),
each layer gathers its own parameters to their tensor-parallel placements
as it starts, inside the remat, as the reference gathers each scan
iteration's (`_fsdp_gather`).

Every entry point takes `params`, an `LMParams`, and the `ArchConfig`, as
the reference takes its parameter tree. Parameters are made with
`requires_grad=False`, so serving keeps no graph; the training code
(`train/train_step.py`) turns them on with `params.requires_grad_(True)`.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils import checkpoint as _ckpt

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import hints as H
from repro_torch.distributed import sharding as SH
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S


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


def _frozen(t):
    return None if t is None else nn.Parameter(t, requires_grad=False)


class LMParams(nn.Module):
    """The parameters of an LM.

    * `embed` (V, D), tied to the output head unless `lm_head` (D, V) is
      present; for the audio frontend `codebook_embed` (ncb, V, D) and
      `codebook_head` (ncb, D, V) instead;
    * `vision_proj` {w1 (vision_dim, D), w2 (D, D)} for the vision frontend;
    * `final_norm` (D,);
    * `layers`, one `ParamTree` a layer in layer order: an attention layer
      holds `ln1`, `attn` {wq, wk, wv, wo[, q_norm, k_norm]}, `ln2`, `mlp`
      {wi_gate, wi_up, wo} or `moe` {router, wi_gate, wi_up, wo[, shared]}
      and, with post-norms, `post_ln1` / `post_ln2`; an SSM layer `ln` and
      `ssm`; a `shared_attn` layer nothing;
    * `shared_attn`, the one {ln1, attn, ln2, mlp} every `shared_attn`
      position applies.
    """

    def __init__(self, embed, final_norm, layers: list[dict], lm_head=None, *, shared_attn=None,
                 codebook_embed=None, codebook_head=None, vision_proj=None):
        super().__init__()
        self.embed = _frozen(embed)
        self.final_norm = _frozen(final_norm)
        self.lm_head = _frozen(lm_head)
        self.codebook_embed = _frozen(codebook_embed)
        self.codebook_head = _frozen(codebook_head)
        self.vision_proj = None if vision_proj is None else ParamTree(vision_proj)
        self.shared_attn = None if shared_attn is None else ParamTree(shared_attn)
        self.layers = nn.ModuleList(ParamTree(p) for p in layers)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def _zeros(gen: torch.Generator, d: int, dtype):
    return torch.zeros((d,), dtype=dtype, device=gen.device)


def _dense_mlp(gen: torch.Generator, cfg: ArchConfig, dtype) -> dict:
    d = cfg.d_model
    return {
        "wi_gate": L.dense_init(gen, (d, cfg.d_ff), dtype=dtype),
        "wi_up": L.dense_init(gen, (d, cfg.d_ff), dtype=dtype),
        "wo": L.dense_init(gen, (cfg.d_ff, d), dtype=dtype),
    }


def _init_layer(gen: torch.Generator, cfg: ArchConfig, kind: str, mlp_kind: str, dtype) -> dict:
    d = cfg.d_model
    if kind == "ssm":
        return {"ln": _zeros(gen, d, dtype), "ssm": S.init_ssm_params(gen, cfg, dtype)}
    if kind == "shared_attn":
        return {}  # the weights live in LMParams.shared_attn
    p = {"ln1": _zeros(gen, d, dtype), "attn": A.init_attn_params(gen, cfg, dtype),
         "ln2": _zeros(gen, d, dtype)}
    if cfg.post_norm:
        p["post_ln1"], p["post_ln2"] = _zeros(gen, d, dtype), _zeros(gen, d, dtype)
    if mlp_kind == "moe":
        p["moe"] = M.init_moe_params(gen, cfg, dtype)
    else:
        p["mlp"] = _dense_mlp(gen, cfg, dtype)
    return p


def init_params(cfg: ArchConfig, *, seed: int = 0, dtype=torch.float32, device="cuda") -> LMParams:
    """Random parameters on `device`, drawn from a `torch.Generator` seeded
    with `seed` (norm scales zero, as the reference initialises them).
    `dtype` is every weight's but the MoE router's and the SSM's `A_log`,
    `D` and `dt_bias`, which are fp32. On `device="meta"` the parameters
    are shapes and dtypes only: nothing is drawn or allocated."""
    dev = _device.resolve(device)
    gen = L.MetaGenerator() if dev.type == "meta" else torch.Generator(dev).manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab
    kw = {}
    embed = lm_head = None
    if cfg.modality == "audio_tokens":
        kw["codebook_embed"] = L.dense_init(gen, (cfg.n_codebooks, v, d), in_axis=2, dtype=dtype)
        kw["codebook_head"] = L.dense_init(gen, (cfg.n_codebooks, d, v), in_axis=1, dtype=dtype)
    else:
        embed = L.dense_init(gen, (v, d), in_axis=1, dtype=dtype)
        if not cfg.tie_embeddings:
            lm_head = L.dense_init(gen, (d, v), dtype=dtype)
    if cfg.modality == "vision_text":
        kw["vision_proj"] = {"w1": L.dense_init(gen, (cfg.vision_dim, d), dtype=dtype),
                             "w2": L.dense_init(gen, (d, d), dtype=dtype)}
    if "shared_attn" in cfg.layer_kinds():
        kw["shared_attn"] = {"ln1": _zeros(gen, d, dtype), "attn": A.init_attn_params(gen, cfg, dtype),
                             "ln2": _zeros(gen, d, dtype), "mlp": _dense_mlp(gen, cfg, dtype)}
    layers = [_init_layer(gen, cfg, kind, mlp_kind, dtype) for kind, mlp_kind in layer_descs(cfg)]
    return LMParams(embed, _zeros(gen, d, dtype), layers, lm_head, **kw)


# ---------------------------------------------------------------------------
# per-layer apply
# ---------------------------------------------------------------------------


def _mlp_and_norms(lp, cfg: ArchConfig, mlp_kind: str, x, attn_out):
    """The attention residual, then the MLP (dense or MoE) and its residual.
    Returns (x, the MoE block's aux or None)."""
    if cfg.post_norm:
        attn_out = L.rms_norm(attn_out, lp["post_ln1"], cfg.norm_eps)
    x = x + attn_out
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    aux = None
    if mlp_kind == "moe":
        mlp_out, aux = M.moe_block(lp["moe"], cfg, h)
    else:
        mlp = lp["mlp"]
        mlp_out = L.gated_mlp(h, mlp["wi_gate"], mlp["wi_up"], mlp["wo"])
    if cfg.post_norm:
        mlp_out = L.rms_norm(mlp_out, lp["post_ln2"], cfg.norm_eps)
    return x + mlp_out, aux


def _attn_params(lp, shared_p, kind: str):
    """(the layer's parameters, the attention kind): a `shared_attn`
    position applies the shared block as global attention."""
    return (shared_p, "global") if kind == "shared_attn" else (lp, kind)


def _apply_layer(lp, shared_p, cfg: ArchConfig, kind: str, mlp_kind: str, x, positions):
    """Full-sequence layer. Returns (x, cache entry, MoE aux or None)."""
    if kind == "ssm":
        h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
        out, cache = S.ssm_block(lp["ssm"], cfg, h, return_cache=True)
        return x + out, cache, None
    lp, kind = _attn_params(lp, shared_p, kind)
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn_out, (k, v) = A.attention_block(lp["attn"], cfg, h, positions, kind=kind)
    x, aux = _mlp_and_norms(lp, cfg, mlp_kind, x, attn_out)
    return x, {"k": k, "v": v}, aux


def _apply_layer_decode(lp, shared_p, cfg: ArchConfig, kind: str, mlp_kind: str, x1, cache, pos):
    """Single-token layer; `cache` is written in place."""
    if kind == "ssm":
        h = L.rms_norm(x1, lp["ln"], cfg.norm_eps)
        out, cache = S.ssm_decode_block(lp["ssm"], cfg, h, cache)
        return x1 + out, cache
    lp, kind = _attn_params(lp, shared_p, kind)
    h = L.rms_norm(x1, lp["ln1"], cfg.norm_eps)
    attn_out, cache = A.attention_decode_block(lp["attn"], cfg, h, cache, pos, kind=kind)
    return _mlp_and_norms(lp, cfg, mlp_kind, x1, attn_out)[0], cache


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _scaled(x, cfg: ArchConfig, act_dtype):
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=act_dtype, device=x.device)
    return x


def _lookup(table, ids):
    """`table[ids]`, on a DTensor table `_lookup_sharded`."""
    return _lookup_sharded(table, ids) if isinstance(table, DTensor) else table[ids]


def _lookup_sharded(table: DTensor, ids) -> DTensor:
    """The vocabulary-parallel lookup of a DTensor table (V, D): each rank
    looks its ids up in its own block of the vocabulary (the table whole
    along D), zero for ids outside it, and the rows come back a partial sum
    over the mesh dims that split the vocabulary; the ids keep their batch
    split on the other mesh dims. DTensor's own rules would gather every
    rank's ids and gradient rows (indexing) or apply a mask of one layout
    to rows of another (`F.embedding`'s masked partial, with a table also
    split along D)."""
    mesh = table.device_mesh
    ids = SH.as_dtensor(ids, mesh)

    def split(p, dim):
        return isinstance(p, Shard) and p.dim == dim

    vocab = [split(p, 0) for p in table.placements]
    t_pl = [Shard(0) if v else Replicate() for v in vocab]
    i_pl = [Shard(0) if split(p, 0) and not v else Replicate()
            for p, v in zip(ids.placements, vocab)]
    # a rank's rows take gradients from its own ids alone: a partial sum
    # over the mesh dims that split the ids
    grad_pl = [Partial() if split(i, 0) else t for i, t in zip(i_pl, t_pl)]
    rows = table.redistribute(mesh, t_pl).to_local(grad_placements=grad_pl)
    loc = ids.redistribute(mesh, i_pl).to_local()
    off, size = SH.block_offsets(table.shape, t_pl, mesh).get(0, (0, table.shape[0]))
    at = loc.long() - off
    mine = (at >= 0) & (at < size)
    out = torch.where(mine[..., None], rows[at.clamp(0, size - 1)], 0.0)
    shape = (*ids.shape, table.shape[1])
    return DTensor.from_local(out, mesh, [Partial() if v else p for v, p in zip(vocab, i_pl)],
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def embed_inputs(params: LMParams, cfg: ArchConfig, batch, act_dtype=torch.bfloat16):
    """batch -> (x (B, S, D), positions (S,)).

    Text: {"tokens": (B, S)}. Audio: {"tokens": (B, S, ncb)}, the codebook
    embeddings summed in codebook order in the activation dtype. Vision:
    {"tokens": (B, S_text), "patch_embeds": (B, P, vision_dim)}, the
    projected patches (w1, tanh GELU, w2) before the text. Rows are
    gathered before the cast to `act_dtype` (the same values as casting
    the table first); `embed_scale` multiplies by sqrt(d_model) cast to the
    activation dtype."""
    dev = params.device
    tokens = batch["tokens"].to(dev).long()
    if cfg.modality == "audio_tokens":
        emb = params.codebook_embed
        x = torch.zeros((*tokens.shape[:2], cfg.d_model), dtype=act_dtype, device=dev)
        for cb in range(cfg.n_codebooks):
            x = x + _lookup(emb[cb], tokens[..., cb]).to(act_dtype)
    elif cfg.modality == "vision_text":
        vp = params.vision_proj
        patches = batch["patch_embeds"].to(dev).to(act_dtype)
        pe = SH.matmul(L.gelu(SH.matmul(patches, vp["w1"].to(act_dtype))), vp["w2"].to(act_dtype))
        x = torch.cat([pe, _lookup(params.embed, tokens).to(act_dtype)], dim=1)
    else:
        x = _lookup(params.embed, tokens).to(act_dtype)
    x = _scaled(x, cfg, act_dtype)
    return x, torch.arange(x.shape[1], device=dev)


def lm_logits(params: LMParams, cfg: ArchConfig, x) -> torch.Tensor:
    """(..., D) hidden -> fp32 logits, (..., V), or (..., ncb, V) for the
    audio heads: the tied embedding (or `lm_head`), then the final
    softcap."""
    x32 = x.float()
    if cfg.modality == "audio_tokens":
        logits = SH.einsum("...d,cdv->...cv", x32, params.codebook_head.float())
    elif cfg.tie_embeddings:
        logits = SH.matmul(x32, params.embed.float().T)
    else:
        logits = SH.matmul(x32, params.lm_head.float())
    return L.softcap(logits, cfg.logit_softcap)


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


def _fsdp_gather(lp):
    """A layer's parameters as a nested dict, each DTensor redistributed to
    its tensor-parallel placements (the FSDP placements with the data axes
    dropped: an all-gather over them); the backward reduce-scatters the
    gradients back. Only one layer's gathered copy is alive at a time: the
    gather runs inside the function `torch.utils.checkpoint` wraps, so the
    backward's recomputation gathers again."""
    def walk(tree, prefix):
        out = {}
        for name, p in tree._parameters.items():
            if isinstance(p, DTensor):
                spec = SH._param_spec(prefix + name, tuple(p.shape), SH.axis_sizes(p.device_mesh),
                                      stacked=False)
                p = p.redistribute(p.device_mesh, SH.placements(spec, p.device_mesh))
            out[name] = p
        for name, sub in tree._modules.items():
            out[name] = walk(sub, prefix + name + ".")
        return out

    return walk(lp, "")


def _apply_layer_fsdp(lp, *args):
    return _apply_layer(_fsdp_gather(lp), *args)


# the products whose outputs remat_policy="dots" saves (the reference's
# `checkpoint_dots`); everything else is recomputed in the backward
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.baddbmm.default)


def _remat_context(policy: str):
    if policy == "full":
        return _ckpt.noop_context_fn
    if policy == "dots":
        return functools.partial(_ckpt.create_selective_checkpoint_contexts, list(_DOTS))
    raise ValueError(f"remat_policy must be 'full' or 'dots', not {policy!r}")


def forward(params: LMParams, cfg: ArchConfig, batch, *, act_dtype=torch.bfloat16,
            return_cache: bool = False, remat: bool = True, return_hidden: bool = False,
            remat_policy: str = "full"):
    """Full-sequence forward. Returns (logits | hidden, aux[, caches]).

    `hidden` is the post-`final_norm` state (B, S, D); `aux` the fp32 sum of
    the MoE layers' `moe_lb_loss` (zero without MoE); `caches` one entry a
    layer: {"k", "v"} of (B, S, K, Dh), or an SSM layer's {"h", "conv"}.

    With `remat` and gradients on, each layer runs under
    `torch.utils.checkpoint` (non-reentrant): `remat_policy="full"` keeps
    only its input and recomputes the rest in the backward, `"dots"` also
    keeps the products' outputs. Without gradients there is nothing to
    remat, and the layers run as they are."""
    context_fn = _remat_context(remat_policy)
    remat = remat and torch.is_grad_enabled()
    hints = H.get_hints()
    apply_layer = _apply_layer_fsdp if hints is not None and hints.fsdp else _apply_layer
    x, positions = embed_inputs(params, cfg, batch, act_dtype)
    bpos = positions[None, :].expand(x.shape[0], -1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for lp, (kind, mlp_kind) in zip(params.layers, layer_descs(cfg)):
        args = (lp, params.shared_attn, cfg, kind, mlp_kind, x, bpos)
        if remat:
            x, entry, layer_aux = _ckpt.checkpoint(apply_layer, *args, use_reentrant=False,
                                                   context_fn=context_fn)
        else:
            x, entry, layer_aux = apply_layer(*args)
        if layer_aux is not None:
            aux = aux + layer_aux["moe_lb_loss"]
        if return_cache:
            caches.append(entry)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    out = x if return_hidden else lm_logits(params, cfg, x)
    if return_cache:
        return out, aux, caches
    return out, aux


def make_cache(cfg: ArchConfig, batch_size: int, s_max: int, dtype=torch.bfloat16,
               device="cuda") -> list[dict]:
    """An empty cache, one entry a layer: {"k", "v"} of (B, s_max, K, Dh),
    or for an SSM layer {"h": (B, nh, hd, st) fp32, "conv": (B, W - 1, C)}."""
    dev = _device.resolve(device)
    out = []
    for kind in cfg.layer_kinds():
        if kind == "ssm":
            out.append({
                "h": torch.zeros((batch_size, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                                 dtype=torch.float32, device=dev),
                "conv": torch.zeros((batch_size, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                                    dtype=dtype, device=dev),
            })
        else:
            shape = (batch_size, s_max, cfg.n_kv_heads, cfg.head_dim)
            out.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                        "v": torch.zeros(shape, dtype=dtype, device=dev)})
    return out


def prefill(params: LMParams, cfg: ArchConfig, batch, s_max: int | None = None,
            act_dtype=torch.bfloat16, return_hidden: bool = False):
    """Process the prompt; returns (last-position logits (B, V) or
    (B, ncb, V), caches, prompt length), and with `return_hidden=True` also
    the post-`final_norm` hidden state of the last prompt position (B, D),
    the retrieval query of the first generated token. Only the last
    position's logits are computed; the KV caches are zero-padded to
    `s_max` slots (an SSM layer's state has no length)."""
    hidden, _, caches = forward(params, cfg, batch, act_dtype=act_dtype, return_cache=True,
                                remat=False, return_hidden=True)
    logits = lm_logits(params, cfg, hidden[:, -1:])
    s = hidden.shape[1]
    if s_max is not None and s_max > s:
        pad = (0, 0, 0, 0, 0, s_max - s)
        caches = [{"k": F.pad(c["k"], pad), "v": F.pad(c["v"], pad)} if "k" in c else c
                  for c in caches]
    if return_hidden:
        return logits[:, -1], caches, s, hidden[:, -1]
    return logits[:, -1], caches, s


def decode_step(params: LMParams, cfg: ArchConfig, caches, tokens, pos,
                act_dtype=torch.bfloat16, return_hidden: bool = False):
    """One decode step for every sequence: tokens (B,), or (B, ncb) for
    audio, at positions pos (B,). Vision decode is text-only (the patches
    were consumed at prefill).

    The caches are updated in place (the reference donates them). Returns
    (logits (B, V) or (B, ncb, V), caches), and with `return_hidden=True`
    also the post-`final_norm` hidden state (B, D) the logits were read
    from."""
    if cfg.modality == "vision_text":
        x = _lookup(params.embed, tokens.to(params.device).long()[:, None]).to(act_dtype)
        x = _scaled(x, cfg, act_dtype)
    else:
        x, _ = embed_inputs(params, cfg, {"tokens": tokens[:, None]}, act_dtype)
    pos = pos.to(x.device)
    for lp, (kind, mlp_kind), cache in zip(params.layers, layer_descs(cfg), caches):
        x, _ = _apply_layer_decode(lp, params.shared_attn, cfg, kind, mlp_kind, x, cache, pos)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = lm_logits(params, cfg, x)
    if return_hidden:
        return logits[:, 0], caches, x[:, 0]
    return logits[:, 0], caches
