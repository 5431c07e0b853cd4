"""Gradient compression for the cross-pod reduction.

A port of the JAX package's `distributed/compression.py`: int8
block-quantized mean over a process group, and error feedback (a
persistent residual) so that quantization noise does not bias
convergence. The reference's `axis` name becomes a `torch.distributed`
process group.

`quantize_int8` and `dequantize_int8` are bitwise the reference's on the
same fp32 input: `torch.round` and `jnp.round` both round half to even, and
fp32 division is IEEE on both sides.

The wire payload of `compressed_psum_mean` is the reference's: the per-block
maxima in the input dtype, then `q` widened to int32 so that the sum over
the group is exact. For an fp32 tensor that is 4 bytes an element plus 4
bytes a block: no fewer bytes than an fp32 all-reduce.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """x flattened, zero-padded to a multiple of `block`, as (n_blocks, block)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, block)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d by IEEE division on every device: on a card, a Python-scalar
    divisor is applied as a multiplication by its reciprocal, which can
    differ in the last bit."""
    return x / x.new_tensor(d)


def _quantize(blocks: torch.Tensor, amax: torch.Tensor):
    """(q int8, scale): scale = max(amax / 127, 1e-12), q = round(blocks /
    scale) clipped to [-127, 127]."""
    scale = torch.clamp_min(_div(amax, 127.0), 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8(x: torch.Tensor, block: int = 256):
    """Symmetric per-block int8 quantization. Returns (q (n_blocks, block)
    int8, scales (n_blocks, 1) fp32)."""
    blocks = _blocks(x, block)
    q, scale = _quantize(blocks, blocks.abs().amax(dim=1, keepdim=True))
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, block: int = 256) -> torch.Tensor:
    """fp32 `q * scale`, cut to the elements of `shape`."""
    n = 1
    for d in shape:
        n *= d
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def compressed_psum_mean(x: torch.Tensor, group=None, block: int = 256) -> torch.Tensor:
    """The mean of `x` over the ranks of `group` (the default group when
    None) with an int8 payload; every rank of the group must call it, and
    gets the same result, in `x`'s dtype.

    Two phases: (1) an all-reduce MAX of the per-block maxima gives a
    shared scale; (2) every rank quantizes against it, the q sum exactly
    in int32 in a second all-reduce, and one dequantize over the group
    size gives the mean. The error is bounded by half a quantization step:
    no term from mismatched scales."""
    blocks = _blocks(x, block)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    q, scale = _quantize(blocks, amax)
    q_sum = q.to(torch.int32)
    dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    out = (q_sum.float() * scale).reshape(-1)[: x.numel()].reshape(x.shape)
    return _div(out, float(n)).to(x.dtype)


class ErrorFeedback:
    """Residual-carrying compressor: g_hat = C(g + e); e += g - g_hat, over
    gradient dicts (parameter name -> tensor)."""

    @staticmethod
    def init(params: dict) -> dict:
        return {name: torch.zeros_like(p, dtype=torch.float32) for name, p in params.items()}

    @staticmethod
    def compress(grads: dict, residual: dict, block: int = 256):
        """(compressed gradients in each gradient's dtype, new residual fp32)."""
        sent, resid = {}, {}
        for name, g in grads.items():
            x = g.float() + residual[name]
            q, s = quantize_int8(x, block)
            deq = dequantize_int8(q, s, x.shape, block)
            sent[name], resid[name] = deq.to(g.dtype), x - deq
        return sent, resid
