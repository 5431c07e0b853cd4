"""Shared model primitives: RMSNorm, RoPE, gated MLP, soft-capping, inits,
and the vision projector's GELU.

A port of the JAX package's `models/layers.py`, operation for operation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as SH


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32, scaled by `1 + scale`, cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping; identity when cap == 0."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> (sin, cos) of shape (..., head_dim // 2), fp32."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exponent)
    angle = positions.float()[..., None] * freq
    return torch.sin(angle), torch.cos(angle)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, Dh); sin / cos (..., S, Dh/2) broadcast over heads. The
    half-split rotation (first half against second half), not interleaved."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin, cos = sin[..., None, :], cos[..., None, :]  # add the head axis
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def gated_mlp(x, wi_gate, wi_up, wo, act=F.silu) -> torch.Tensor:
    """SwiGLU-style gated MLP: (x @ Wg).act * (x @ Wu) @ Wo."""
    g = act(SH.matmul(x, wi_gate.to(x.dtype)))
    u = SH.matmul(x, wi_up.to(x.dtype))
    return SH.matmul(g * u, wo.to(x.dtype))


class MetaGenerator:
    """Stands in for a `torch.Generator` where parameters are shapes only
    (`init_params(device="meta")`): `dense_init` draws nothing from it."""

    device = torch.device("meta")


def dense_init(gen: torch.Generator, shape, in_axis: int = 0, dtype=torch.float32) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], times fan_in^-0.5, drawn from
    `gen` on its device. The draws are not `jax.random`'s: parameters are
    carried from the JAX package with `convert.lm_params_from_jax`."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if t.is_meta:
        return t.to(dtype)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * shape[in_axis] ** -0.5).to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximated GELU: `jax.nn.gelu`'s default
    (`approximate=True`), not PyTorch's exact default."""
    return F.gelu(x, approximate="tanh")
