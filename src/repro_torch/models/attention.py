"""Attention: GQA with RoPE, qk-norm, soft-capping, global and local
(sliding-window) variants, blockwise (online-softmax) computation for long
sequences, and single-token decode against a KV cache.

A port of the JAX package's `models/attention.py`. Attention there is plain
`einsum`, not a Pallas kernel, so it is plain PyTorch here (`sharding.einsum`
and `sharding.reshape`: `torch.einsum` and `reshape` on plain tensors), with the same
arithmetic: scores scaled by `dh^-0.5` in the activation dtype, then cast
to fp32 and soft-capped; masks fill with `NEG_INF` (not -inf); the
probabilities are cast to v's dtype before the product.
`scaled_dot_product_attention` is not used: it has no softcap.

Layout conventions:
  activations x        (B, S, D)
  q                    (B, S, H, Dh)
  k, v                 (B, S, K, Dh)        K = n_kv_heads, G = H // K
  KV cache             (B, S_max, K, Dh)    one per layer
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L

NEG_INF = -(2.0**30)  # large-negative instead of -inf: keeps softmax NaN-free


def init_attn_params(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": L.dense_init(gen, (d, h, dh), dtype=dtype),
        "wk": L.dense_init(gen, (d, kv, dh), dtype=dtype),
        "wv": L.dense_init(gen, (d, kv, dh), dtype=dtype),
        "wo": L.dense_init(gen, (h, dh, d), dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((dh,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros((dh,), dtype=dtype, device=gen.device)
    return p


def qkv(p, cfg: ArchConfig, x, positions):
    """Project + RoPE. x (B, S, D), positions (B, S) -> q, k, v."""
    q = SH.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = SH.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = SH.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    sin, cos = L.rope_freqs(positions, cfg.head_dim, cfg.rope_theta)
    return L.apply_rope(q, sin, cos), L.apply_rope(k, sin, cos), v


def _scores(q, k, cfg: ArchConfig) -> torch.Tensor:
    """q (B, Sq, H, Dh), k (B, Sk, K, Dh) -> (B, K, G, Sq, Sk) fp32, scaled
    and soft-capped."""
    b, sq, h, dh = q.shape
    kk = k.shape[2]
    qg = SH.reshape(q, b, sq, kk, h // kk, dh)
    s = SH.einsum("bskgd,btkd->bkgst", qg, k) * (dh**-0.5)
    return L.softcap(s.float(), cfg.attn_softcap)


def _combine(scores, v) -> torch.Tensor:
    """scores (B, K, G, Sq, Sk) fp32, v (B, Sk, K, Dh) -> (B, Sq, H, Dh)."""
    b, kk, g, sq, _ = scores.shape
    out = SH.einsum("bkgst,btkd->bskgd", scores.to(v.dtype), v)
    return SH.reshape(out, b, sq, kk * g, v.shape[-1])


def _masked_softmax(s, mask) -> torch.Tensor:
    return torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)


def full_attention(q, k, v, cfg: ArchConfig, q_pos, k_pos, window: int = 0):
    """Materialized-score causal attention (short sequences)."""
    s = _scores(q, k, cfg)  # (B, K, G, Sq, Sk)
    mask = q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return _combine(_masked_softmax(s, mask), v)


def blockwise_attention(q, k, v, cfg: ArchConfig, *, window: int = 0, q_chunk: int = 512,
                        kv_chunk: int = 1024):
    """Causal online-softmax attention over chunk pairs; optional window.

    Local layers attend to one fixed-size KV slice per q-chunk. Global
    layers carry (max, sum, acc) over the KV chunks up to the q-chunk's last
    position; the reference also visits the later, fully masked chunks,
    which add exactly nothing (alpha = 1, p = 0), so stopping there gives
    the same values.
    """
    b, s, h, dh = q.shape
    q_chunk = min(q_chunk, s)
    while s % q_chunk:
        q_chunk //= 2
    dev = q.device
    outs = []
    for p0 in range(0, s, q_chunk):
        qc = q[:, p0 : p0 + q_chunk]
        q_pos = p0 + torch.arange(q_chunk, device=dev)
        if window:
            lsize = min(window + q_chunk, s)
            start = min(max(p0 + q_chunk - lsize, 0), s - lsize)
            k_pos = start + torch.arange(lsize, device=dev)
            sc = _scores(qc, k[:, start : start + lsize], cfg)
            mask = (q_pos[:, None] >= k_pos[None, :]) & (q_pos[:, None] - k_pos[None, :] < window)
            outs.append(_combine(_masked_softmax(sc, mask), v[:, start : start + lsize]))
            continue
        kv_c = min(kv_chunk, s)
        while s % kv_c:
            kv_c //= 2
        kk = k.shape[2]
        g = h // kk
        m = torch.full((b, kk, g, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l_sum = torch.zeros((b, kk, g, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kk, g, q_chunk, dh), dtype=v.dtype, device=dev)
        for t0 in range(0, p0 + q_chunk, kv_c):
            vc = v[:, t0 : t0 + kv_c]
            k_pos = t0 + torch.arange(kv_c, device=dev)
            sc = _scores(qc, k[:, t0 : t0 + kv_c], cfg)  # (B, K, G, qc, kv_c)
            sc = torch.where(q_pos[:, None] >= k_pos[None, :], sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            pr = torch.exp(sc - m_new[..., None])
            l_sum = l_sum * alpha + pr.sum(-1)
            pv = SH.einsum("bkgst,btkd->bkgsd", pr.to(vc.dtype), vc)
            acc = acc * alpha[..., None].to(acc.dtype) + pv
            m = m_new
        out = acc / l_sum.clamp_min(1e-30)[..., None].to(acc.dtype)
        outs.append(SH.reshape(out.movedim(3, 1), b, q_chunk, h, dh))
    return torch.cat(outs, dim=1)


def decode_attention(q1, cache_k, cache_v, cfg: ArchConfig, pos, window: int = 0):
    """One-token attention: q1 (B, 1, H, Dh) against the cache (B, Smax, K, Dh).

    `pos` (B,) is where the current token sits (the cache already holds it);
    the mask admits slots <= pos (and within the window on local layers).
    """
    smax = cache_k.shape[1]
    sc = _scores(q1, cache_k, cfg)  # (B, K, G, 1, Smax)
    k_pos = torch.arange(smax, device=q1.device)
    mask = k_pos[None, :] <= pos[:, None]  # (B, Smax)
    if window:
        mask &= (pos[:, None] - k_pos[None, :]) < window
    return _combine(_masked_softmax(sc, mask[:, None, None, None, :]), cache_v)


def attention_block(p, cfg: ArchConfig, x, positions, *, kind: str,
                    blockwise_threshold: int = 8192):
    """Full-sequence attention (prefill / harvest). Returns (out, (k, v))."""
    q, k, v = qkv(p, cfg, x, positions)
    window = cfg.window if kind == "local" else 0
    s = x.shape[1]
    if s > blockwise_threshold or (window and s > 2 * window):
        out = blockwise_attention(q, k, v, cfg, window=window)
    else:
        qp = positions[0]
        out = full_attention(q, k, v, cfg, qp, qp, window=window)
    return SH.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)), (k, v)


def _write_slot_sharded(cache: DTensor, new, slot) -> None:
    """`cache[b, slot[b]] = new[b]` on a DTensor cache (B, Smax, K, Dh)
    whose batch, sequence and head dims may be sharded, written into each
    rank's own block (DTensor has no in-place rule for the scattered
    write): `new` (B, K, Dh) and `slot` (B,) are redistributed to the
    cache's batch and head sharding (replicated along the sequence's mesh
    dims), and a rank whose sequence block misses a row's slot writes that
    row's old entry back."""
    mesh, pl = cache.device_mesh, list(cache.placements)
    # new / slot along the cache's sharded dims: batch (0) and heads (2 -> 1)
    new_pl = [Shard({0: 0, 2: 1}[p.dim]) if isinstance(p, Shard) and p.dim in (0, 2)
              else Replicate() for p in pl]
    slot_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pl]
    new_l = SH.as_dtensor(new, mesh).redistribute(mesh, new_pl).to_local()
    slot_l = SH.as_dtensor(slot, mesh).redistribute(mesh, slot_pl).to_local()
    local = cache.to_local()
    s_off, s_loc = SH.block_offsets(cache.shape, pl, mesh).get(1, (0, cache.shape[1]))
    rows = torch.arange(local.shape[0], device=local.device)
    at = slot_l - s_off
    mine = (at >= 0) & (at < s_loc)
    at = at.clamp(0, s_loc - 1)
    local[rows, at] = torch.where(mine[:, None, None], new_l.to(local.dtype), local[rows, at])


def attention_decode_block(p, cfg: ArchConfig, x1, cache: dict, pos, *, kind: str):
    """Single-token decode. x1 (B, 1, D); `cache` holds k / v (B, Smax, K, Dh)
    and is written in place. Returns (out (B, 1, D), cache).

    The write clamps its slot to [0, Smax - 1], as the reference's
    `dynamic_update_slice_in_dim` clamps its start: a decode at
    pos >= Smax overwrites the last slot, and nothing grows.
    """
    b, smax = x1.shape[0], cache["k"].shape[1]
    q, k_new, v_new = qkv(p, cfg, x1, pos[:, None])
    slot = pos.clamp(0, smax - 1).long()
    if isinstance(cache["k"], DTensor):
        _write_slot_sharded(cache["k"], k_new[:, 0], slot)
        _write_slot_sharded(cache["v"], v_new[:, 0], slot)
    else:
        rows = torch.arange(b, device=x1.device)
        cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    window = cfg.window if kind == "local" else 0
    out = decode_attention(q, cache["k"], cache["v"], cfg, pos, window=window)
    return SH.einsum("bshk,hkd->bsd", out, p["wo"].to(x1.dtype)), cache
