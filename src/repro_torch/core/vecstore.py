"""Dataset vectors: the fp32 rung of the precision ladder.

The JAX package's `core/vecstore.py` holds vectors at fp32, bf16 or int8;
this port has the fp32 rung only, over plain (N, D) tensors. These helpers
are the one place the build and search layers read rows, so the other rungs
can land here later.
"""

from __future__ import annotations

import torch


def parts(x: torch.Tensor):
    """(data, scale, offset) of the dataset operand: (x, None, None) at fp32."""
    return x, None, None


def nrows(x: torch.Tensor) -> int:
    return x.shape[0]


def dim(x: torch.Tensor) -> int:
    return x.shape[1]


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows (any index shape) -> fp32."""
    return x[idx.long()].float()


def dequant(x: torch.Tensor) -> torch.Tensor:
    """(N, D) fp32 view."""
    return x.float()
