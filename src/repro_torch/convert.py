"""Carry state from the JAX reference into the port."""

from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.core.pools import Pool


def from_jax(pool_ids, pool_dists, x, device="cuda"):
    """The reference's pool and dataset (numpy arrays, or anything
    `np.array` takes) as the port's tensors: (Pool, x) on `device`."""
    dev = _device.resolve(device)
    ids = _device.put(pool_ids, torch.int32, dev)
    dists = _device.put(pool_dists, torch.float32, dev)
    return Pool(ids, dists), _device.put(x, torch.float32, dev)
