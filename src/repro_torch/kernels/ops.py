"""Dispatch surface for the five kernels of the build-and-search path.

Backends:
  * "auto" — by the tensor's device: a CUDA tensor runs the hand-written
    CUDA kernel, a CPU tensor the plain PyTorch version in `ref.py`.
    Whether a card is present plays no part, and nothing falls back: a
    CUDA tensor launches its kernel or raises.
  * "ref"  — the plain version on either device. `chip_smoke.py` and the
    tests use it to hold the kernels against their oracle; nothing on the
    main path sets it.

Selection: `set_backend()` or the `backend()` scope at run time, or the
REPRO_TORCH_BACKEND environment variable at import time. (The JAX package
reads REPRO_KERNEL_BACKEND; this package never does.)
"""

from __future__ import annotations

import contextlib
import os

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.pairwise_l2 import pairwise_sqdist as _pairwise
from repro_torch.kernels.pairwise_l2 import rowwise_sqdist as _rowwise
from repro_torch.kernels.rng_round import rng_round as _rng_round
from repro_torch.kernels.search_expand import search_expand as _search_expand
from repro_torch.kernels.topr_merge import topr_merge as _topr_merge

_VALID = ("auto", "ref")


def _normalize(name: str) -> str:
    if name not in _VALID:
        raise ValueError(f"backend must be one of {_VALID}, got {name!r}")
    return name


_BACKEND = _normalize(os.environ.get("REPRO_TORCH_BACKEND", "auto"))


def set_backend(name: str) -> None:
    global _BACKEND
    _BACKEND = _normalize(name)


def get_backend() -> str:
    return _BACKEND


@contextlib.contextmanager
def backend(name: str):
    """Scoped backend override (restores the previous selection on exit)."""
    global _BACKEND
    prev = _BACKEND
    set_backend(name)
    try:
        yield
    finally:
        _BACKEND = prev


def effective_backend(device: str | torch.device) -> str:
    """What runs for tensors on `device`: "cuda" (the kernels) or "ref"."""
    if _BACKEND == "ref" or torch.device(device).type == "cpu":
        return "ref"
    return "cuda"


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last `reset_launch_counts()`."""
    return dict(_build.LAUNCHES)


def reset_launch_counts() -> None:
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, D) x (N, D) -> (M, N) squared L2, fp32."""
    if _BACKEND == "ref":
        return ref.pairwise_sqdist_ref(x, y)
    return _pairwise(x, y)


def rowwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, D) x (M, D) -> (M,) squared L2 of corresponding rows, fp32."""
    if _BACKEND == "ref":
        return ref.rowwise_sqdist_ref(x, y)
    return _rowwise(x, y)


def topr_merge(ids: torch.Tensor, dists: torch.Tensor, r: int):
    """(B, W) candidate rows -> (B, r) closest unique entries."""
    if _BACKEND == "ref":
        return ref.topr_merge_ref(ids, dists, r)
    return _topr_merge(ids, dists, r)


def search_expand(x, queries, nbrs, table):
    """One beam-expansion step: (ids, dists, fresh)."""
    if _BACKEND == "ref":
        return ref.search_expand_ref(x, queries, nbrs, table)
    return _search_expand(x, queries, nbrs, table)


def rng_propagation_round(x, ids, dists, si, sj):
    """One disordered propagation round: (dst, src, dij, kill)."""
    if _BACKEND == "ref":
        return ref.rng_round_ref(x, ids, dists, si, sj)
    return _rng_round(x, ids, dists, si, sj)
