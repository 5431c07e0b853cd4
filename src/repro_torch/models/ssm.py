"""Mamba2 (SSD, state-space duality) block: the chunked prefill scan, the
O(1)-state decode step, and the sequential recurrence as the plain version.

A port of the JAX package's `models/ssm.py`, operation for operation.

Recurrence (per batch, per head; state h in R^{hd x st}):
    h_t = a_t * h_{t-1} + (dt_t * x_t) b_t^T          a_t = exp(dt_t * A)
    y_t = h_t c_t + D * x_t

The chunked form splits S into chunks of Q: within a chunk the output is an
attention-like masked product against the decay matrix; across chunks a
Python loop carries the fp32 (nh, hd, st) state (the reference's
`lax.scan`). The products are plain `einsum`s: no kernel of their own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L


def init_ssm_params(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32) -> dict:
    """`A_log`, `D` and `dt_bias` are fp32 whatever `dtype` the rest takes."""
    d, di, st, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * st
    dev = gen.device
    return {
        "in_proj": L.dense_init(gen, (d, 2 * di + 2 * st + nh), dtype=dtype),
        "conv_w": L.dense_init(gen, (cfg.ssm_conv, conv_dim), dtype=dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "norm": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": L.dense_init(gen, (di, d), dtype=dtype),
    }


def _split_proj(cfg: ArchConfig, zxbcdt):
    di, st, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di : 2 * di + 2 * st]
    dt = zxbcdt[..., 2 * di + 2 * st :]
    assert dt.shape[-1] == nh
    return z, xbc, dt


def _causal_conv(xbc, w, bias):
    """Depthwise causal conv over (B, S, C) with taps (W, C): the taps added
    in order, in the activation dtype, then SiLU."""
    width = w.shape[0]
    # zeros of xbc's placement (a DTensor's pad would plan a redistribution)
    pad = torch.cat([xbc.new_zeros((xbc.shape[0], width - 1, xbc.shape[2])), xbc], dim=1)
    out = torch.zeros_like(xbc)
    for i in range(width):
        out = out + pad[:, i : i + xbc.shape[1], :] * w[i][None, None, :]
    return F.silu(out + bias[None, None, :])


def _ssd_chunked(xh, a, b, c, h0, chunk: int):
    """The chunked SSD scan.

    xh (B, S, nh, hd) dt-scaled inputs; a (B, S, nh) per-step decay in
    (0, 1]; b, c (B, S, st); h0 (B, nh, hd, st) the initial state.
    Returns (y (B, S, nh, hd), h_final). The chunk halves until it divides S.
    """
    bsz, s, nh, hd = xh.shape
    st = b.shape[-1]
    q = min(chunk, s)
    while s % q:
        q //= 2
    nchunks = s // q

    xh_c = SH.reshape(xh, bsz, nchunks, q, nh, hd)
    b_c = SH.reshape(b, bsz, nchunks, q, st)
    c_c = SH.reshape(c, bsz, nchunks, q, st)
    la = torch.log(SH.reshape(a, bsz, nchunks, q, nh).clamp_min(1e-37))
    cum = SH.local_along(lambda t: torch.cumsum(t, dim=2), la, 2)  # (B, NC, Q, nh): log prod_{t <= i}
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))

    h = h0
    ys = []
    for i in range(nchunks):
        xh_i, b_i, c_i, cum_i = xh_c[:, i], b_c[:, i], c_c[:, i], cum[:, i]
        # intra-chunk: y[i] = sum_{j <= i} (c_i . b_j) exp(cum_i - cum_j) xh[j],
        # masked in log space (an exp of the positive masked-out entries
        # would overflow)
        li = cum_i[:, :, None, :] - cum_i[:, None, :, :]  # (B, Q, Q, nh)
        dec = torch.exp(torch.where(causal[None, :, :, None], li, -1e30))
        cb = SH.einsum("bis,bjs->bij", c_i, b_i)
        y_intra = SH.einsum("bijh,bjhd->bihd", cb[..., None] * dec, xh_i)
        # inter-chunk: y[i] += (prod_{t <= i} a) * c_i^T h_in
        y_inter = SH.einsum("bis,bhds->bihd", c_i, h) * torch.exp(cum_i)[..., None]
        ys.append(y_intra + y_inter)
        # the state: h_out = (prod_chunk a) h_in + sum_j (prod_{t > j} a) xh_j b_j^T
        tot = cum_i[:, -1, :]  # (B, nh)
        rem = torch.exp(tot[:, None, :] - cum_i)  # (B, Q, nh)
        h = torch.exp(tot)[:, :, None, None] * h + SH.einsum(
            "bjhd,bjs->bhds", rem[..., None] * xh_i, b_i
        )
    y = SH.reshape(torch.stack(ys, dim=1), bsz, s, nh, hd)
    return y, h


def ssd_naive(xh, a, b, c, h0):
    """The sequential recurrence, one step a position: the plain version of
    `_ssd_chunked` (same signature), for the tests and `chip_smoke.py`."""
    h = h0
    ys = []
    for t in range(xh.shape[1]):
        h = a[:, t, :, None, None] * h + SH.einsum("bhd,bs->bhds", xh[:, t], b[:, t])
        ys.append(SH.einsum("bhds,bs->bhd", h, c[:, t]))
    return torch.stack(ys, dim=1), h


def ssm_block(params, cfg: ArchConfig, x, *, h0=None, return_cache: bool = False):
    """Full-sequence Mamba2 block. x (B, S, D) -> (B, S, D) [, cache]; the
    cache is {h (B, nh, hd, st) fp32, conv (B, W - 1, C)}, the conv window
    holding the tail of the *pre-activation* conv input."""
    bsz, s, _ = x.shape
    di, st, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    zxbcdt = SH.matmul(x, params["in_proj"].to(x.dtype))
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(xbc, params["conv_w"].to(x.dtype), params["conv_b"].to(x.dtype))
    xs = SH.reshape(xbc[..., :di], bsz, s, nh, hd).float()
    b = xbc[..., di : di + st].float()
    c = xbc[..., di + st :].float()

    dt = F.softplus(dt.float() + params["dt_bias"])
    a = torch.exp(-torch.exp(params["A_log"])[None, None, :] * dt)  # (B, S, nh)
    xh = xs * dt[..., None]

    if h0 is None:
        h0 = torch.zeros((bsz, nh, hd, st), dtype=torch.float32, device=x.device)
    y, h_final = _ssd_chunked(xh, a, b, c, h0, cfg.ssm_chunk)
    y = y + params["D"][None, None, :, None] * xs
    y = SH.reshape(y, bsz, s, di).to(x.dtype)

    y = L.rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = SH.matmul(y, params["out_proj"].to(x.dtype))
    if return_cache:
        _, xbc_raw, _ = _split_proj(cfg, zxbcdt[:, -(cfg.ssm_conv - 1) :, :])
        return out, {"h": h_final, "conv": xbc_raw}
    return out


def ssm_decode_block(params, cfg: ArchConfig, x1, cache: dict):
    """Single-token decode. x1 (B, 1, D); `cache` {h (B, nh, hd, st),
    conv (B, W - 1, C)} is updated in place (its entries replaced).
    Returns (out (B, 1, D), cache)."""
    bsz = x1.shape[0]
    di, st, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    zxbcdt = SH.matmul(x1, params["in_proj"].to(x1.dtype))
    z, xbc_new, dt = _split_proj(cfg, zxbcdt)  # (B, 1, .)

    conv_win = torch.cat([cache["conv"], xbc_new], dim=1)  # (B, W, C)
    conv_out = SH.einsum("bwc,wc->bc", conv_win, params["conv_w"].to(x1.dtype))
    xbc = F.silu(conv_out + params["conv_b"])[:, None, :]  # (B, 1, C)

    xs = SH.reshape(xbc[..., :di], bsz, nh, hd).float()
    b = xbc[:, 0, di : di + st].float()
    c = xbc[:, 0, di + st :].float()

    dt = F.softplus(dt[:, 0].float() + params["dt_bias"])
    a = torch.exp(-torch.exp(params["A_log"])[None, :] * dt)  # (B, nh)
    xh = xs * dt[..., None]

    h = a[:, :, None, None] * cache["h"] + SH.einsum("bhd,bs->bhds", xh, b)
    y = SH.einsum("bhds,bs->bhd", h, c) + params["D"][None, :, None] * xs
    y = SH.reshape(y, bsz, 1, di).to(x1.dtype)

    y = L.rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = SH.matmul(y, params["out_proj"].to(x1.dtype))
    cache["h"], cache["conv"] = h, conv_win[:, 1:, :]
    return out, cache
