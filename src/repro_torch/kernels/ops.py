"""Dispatch surface for the seven kernels of the build, search and
dynamic-index paths.

Every distance entry point takes the dataset as a plain (N, D) tensor or a
`core.vecstore.VectorStore` (bf16 / int8 storage with a fused dequant);
`parts` duck-types the store, so this module imports nothing from core.

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
from repro_torch.kernels.gather_l2 import gather_sqdist as _gather
from repro_torch.kernels.pairwise_l2 import pairwise_sqdist as _pairwise
from repro_torch.kernels.pairwise_l2 import rowwise_sqdist as _rowwise
from repro_torch.kernels.rng_round import rng_round as _rng_round
from repro_torch.kernels.search_expand import search_expand as _search_expand
from repro_torch.kernels.topr_merge import topr_merge as _topr_merge
from repro_torch.kernels.visited_insert import visited_insert as _visited_insert

_VALID = ("auto", "ref")


def parts(x):
    """(data, scale, offset) of a dataset operand: a store's fields, or
    (x, None, None) for a tensor. Duck-typed on the store's field names (a
    NamedTuple with `data` and `scale`), as the JAX package does."""
    if isinstance(x, tuple) and hasattr(x, "data") and hasattr(x, "scale"):
        return x.data, x.scale, x.offset
    return x, None, None


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


def pairwise_sqdist(x, y) -> torch.Tensor:
    """(M, D) x (N, D) -> (M, N) squared L2, fp32; either side may be a store."""
    xd, xs, xo = parts(x)
    yd, ys, yo = parts(y)
    if _BACKEND == "ref":
        return ref.pairwise_sqdist_ref(xd, yd, xs, xo, ys, yo)
    return _pairwise(xd, yd, xs, xo, ys, yo)


def rowwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, D) x (M, D) -> (M,) squared L2 of corresponding rows, fp32."""
    if _BACKEND == "ref":
        return ref.rowwise_sqdist_ref(x, y)
    return _rowwise(x, y)


def topr_merge(ids: torch.Tensor, dists: torch.Tensor, r: int, flags=None):
    """(B, W) candidate rows -> (B, r) closest unique entries; with (B, F)
    bool `flags` of the first F entries, also the (B, r) flags they carry to
    the output (True in empty slots)."""
    if _BACKEND == "ref":
        return ref.topr_merge_ref(ids, dists, r, flags)
    return _topr_merge(ids, dists, r, flags)


def search_expand(x, queries, nbrs, table, valid=None, vwords=None, fwords=None):
    """One beam-expansion step: (ids, dists, fresh), and `allowed` fourth
    with the label predicate. `x` may be a store; `valid` is the optional
    (N,) tombstone mask; `vwords` (N, W) / `fwords` (Q, W) int32 are the
    predicate words, both or neither (route-through: ids, dists and fresh
    are those of the unfiltered step)."""
    xd, xs, xo = parts(x)
    if _BACKEND == "ref":
        return ref.search_expand_ref(xd, queries, nbrs, table, valid, xs, xo, vwords, fwords)
    return _search_expand(xd, queries, nbrs, table, valid, xs, xo, vwords, fwords)


def rng_propagation_round(x, ids, dists, si, sj):
    """One disordered propagation round: (dst, src, dij, kill); `x` may be a store."""
    xd, xs, xo = parts(x)
    if _BACKEND == "ref":
        return ref.rng_round_ref(xd, ids, dists, si, sj, xs, xo)
    return _rng_round(xd, ids, dists, si, sj, xs, xo)


def gather_sqdist(x, ni, nj) -> torch.Tensor:
    """(M,) d(x[ni[m]], x[nj[m]]) without materialized (M, D) gathers;
    indices clamped to [0, N-1]; `x` may be a store."""
    xd, xs, xo = parts(x)
    if _BACKEND == "ref":
        return ref.gather_sqdist_ref(xd, ni, nj, xs, xo)
    return _gather(xd, ni, nj, xs, xo)


def visited_insert(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Insert (Q, R) ids into the (Q, H) hashed visited tables, in place, in
    column order; returns `table`."""
    if _BACKEND == "ref":
        return ref.visited_insert_ref(table, ids)
    return _visited_insert(table, ids)
