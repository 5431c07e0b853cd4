"""Mesh construction over the default process group.

A port of the JAX package's `launch/mesh.py`: `DeviceMesh`es in place of
`jax.make_mesh`. Importing this module touches no process group; meshes are
built inside the functions only, and every rank of the group must call
them. In place of the reference's roofline constants (its TPU's) stand the
H100's; `join_fake_group` joins a fake default group of N ranks, over which
the dry-run (`launch/dryrun.py`) builds the production meshes in one process.
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
    the group has fewer. Over a fake group the mesh only describes ranks
    elsewhere, so `device` names their type and need not be here."""
    import torch.distributed as dist

    fake = dist.is_initialized() and dist.get_backend() == "fake"
    dev = torch.device(device).type if fake else _device.resolve(device).type
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


def merge_pod(mesh: DeviceMesh) -> DeviceMesh:
    """`mesh`'s ranks with its "pod" and "data" dimensions merged, pod
    major: a ("data", "model") mesh (`mesh` itself without a "pod"
    dimension). The sharding rules split over pod and data together
    (`sharding.data_axes`), so the merged mesh gives every rank the same
    block, and one collective over the pod x data group where DTensor
    would run one a dimension (and plan its redistributions on three
    dimensions by a search that takes minutes a trace)."""
    names = mesh.mesh_dim_names
    if "pod" not in names:
        return mesh
    if names != ("pod", "data", "model"):
        raise ValueError(f"a pod mesh is laid out (pod, data, model), not {names}")
    ranks = mesh.mesh.reshape(-1, mesh.mesh.shape[-1])
    return DeviceMesh(mesh.device_type, ranks, mesh_dim_names=("data", "model"))


def join_fake_group(world: int, rank: int = 0) -> None:
    """Join a fake default process group of `world` ranks as `rank`: its
    collectives return at once and move no data, so one process can stand
    for one rank of a production mesh (`make_production_mesh`) in a trace.
    Raises if this PyTorch has no fake process group, or a default group
    exists already."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry-run needs PyTorch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this PyTorch lacks") from e
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), device: str = "cuda") -> DeviceMesh:
    """A small mesh for tests: gloo ranks on the CPU (`device="cpu"`) or
    NCCL ranks on cards."""
    return _mesh(tuple(shape), tuple(axes), device)



# The roofline constants of one NVIDIA H100 80GB HBM3 (SXM5) at its 700 W
# power limit, as `nvidia-smi --query-gpu=name,power.limit` reads it: NVIDIA's
# H100 SXM5 datasheet, dense rates (no sparsity). A card set below 700 W runs
# slower under load.
CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS_BF16 = 989e12     # FLOP/s, bf16 / fp16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12      # FLOP/s, fp32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s a direction (900 GB/s both ways, NVLink 4)
