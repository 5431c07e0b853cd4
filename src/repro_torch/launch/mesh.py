"""Mesh construction over the default process group.

A port of the JAX package's `launch/mesh.py`: `DeviceMesh`es in place of
`jax.make_mesh`. Importing this module touches no process group; meshes are
built inside the functions only, and every rank of the group must call
them. The reference's roofline constants are its TPU's and are not carried
over.
"""

from __future__ import annotations

import math
import os

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import device as _device
from repro_torch.launch import _group


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device: str) -> DeviceMesh:
    """A mesh of the default group's first prod(shape) ranks; raises when
    the group has fewer."""
    dev = _device.resolve(device).type
    n = math.prod(shape)
    world = _group.world_size()
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found {world}: launch that many ranks "
            "(torchrun --nproc-per-node, or several hosts)")
    if world == n:
        return init_device_mesh(dev, shape, mesh_dim_names=axes)
    return DeviceMesh(dev, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    """16 x 16 ("data", "model"; one pod, 256 ranks) or 2 x 16 x 16
    ("pod", "data", "model"; two pods, 512 ranks).

    REPRO_TORCH_MESH_OVERRIDE="4,4" (or "2,4,4" for two pods) substitutes a
    smaller mesh with the same axis names, its last len(shape) of ("pod",
    "data", "model")."""
    override = os.environ.get("REPRO_TORCH_MESH_OVERRIDE")
    if override:
        shape = tuple(int(v) for v in override.split(","))
        axes = ("pod", "data", "model")[-len(shape):]
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), device: str = "cuda") -> DeviceMesh:
    """A small mesh for tests: gloo ranks on the CPU (`device="cpu"`) or
    NCCL ranks on cards."""
    return _mesh(tuple(shape), tuple(axes), device)

