"""Carry state from the JAX reference into the port.

Every function takes numpy arrays (or anything `np.array` takes: the
reference's arrays convert through `np.asarray`), never JAX objects, so this
module imports nothing of JAX. bf16 arrays (numpy's `bfloat16` extension
dtype, as JAX hands them out) are carried bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.dynamic import DynamicConfig, DynamicIndex
from repro_torch.core.pools import Pool
from repro_torch.core.vecstore import VectorStore


def from_jax(pool_ids, pool_dists, x, device="cuda"):
    """The reference's pool and dataset (numpy arrays, or anything
    `np.array` takes) as the port's tensors: (Pool, x) on `device`."""
    dev = _device.resolve(device)
    ids = _device.put(pool_ids, torch.int32, dev)
    dists = _device.put(pool_dists, torch.float32, dev)
    return Pool(ids, dists), _device.put(x, torch.float32, dev)


def _stored(data, dev: torch.device) -> torch.Tensor:
    """Stored rows as a tensor of the same element type: fp32, int8, or
    bf16 (taken through its 16-bit pattern, so no value is rounded)."""
    a = np.asarray(data)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(dev)
    if a.dtype == np.int8:
        return torch.from_numpy(a.copy()).to(dev)
    return _device.put(a, torch.float32, dev)


def store_from_jax(data, scale=None, offset=None, device="cuda") -> VectorStore:
    """The reference's `VectorStore` (its data, scale and offset as arrays)
    as the port's, on `device`."""
    dev = _device.resolve(device)
    return VectorStore(
        _stored(data, dev),
        None if scale is None else _device.put(scale, torch.float32, dev),
        None if offset is None else _device.put(offset, torch.float32, dev),
    )


def dynamic_from_jax(
    *,
    x,
    store,
    pool_ids,
    pool_dists,
    valid,
    labels,
    size: int,
    n_live: int,
    next_label: int,
    entry,
    rounds_run: int = 0,
    cfg: DynamicConfig = DynamicConfig(),
    draws=None,
    device="cuda",
) -> DynamicIndex:
    """A reference `DynamicIndex`'s state as the port's index: the padded
    fp32 buffer `x`, `store` = (data, scale, offset) of its traversal tier
    or None, the pool, `valid`, `labels`, the counters, the cached `entry`
    (None = not cached) and the localized rounds run so far (the round
    number the next draw is asked for)."""
    dev = _device.resolve(device)
    return DynamicIndex.from_state(
        x=np.asarray(x),
        store=None if store is None else store_from_jax(*store, device=dev),
        pool=Pool(np.asarray(pool_ids), np.asarray(pool_dists)),
        valid=np.asarray(valid),
        labels=np.asarray(labels),
        size=size,
        n_live=n_live,
        next_label=next_label,
        entry=None if entry is None else np.asarray(entry),
        rounds_run=rounds_run,
        cfg=cfg,
        draws=draws,
        device=dev,
    )
