"""Device resolution for the port's entry points.

Entry points default to `"cuda"` and raise when no card is present: the
plain CPU path runs only when the caller asks for it with `device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device to run on; raises if CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def put(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """`x` (a tensor, or anything `np.array` takes) as a contiguous `dtype`
    tensor on `dev`; arrays are copied, so read-only buffers are fine."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=dev, dtype=dtype).contiguous()
