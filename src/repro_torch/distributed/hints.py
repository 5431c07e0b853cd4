"""Mesh hints: lets mesh-agnostic model code opt into explicit sharding.

A port of the JAX package's `distributed/hints.py` over a
`torch.distributed.device_mesh.DeviceMesh`. Model blocks (the
expert-parallel MoE) read `get_hints()` when they run; inside
`use_hints(mesh)` they take their multi-rank path, otherwise the
single-device path the unit tests exercise. With DTensor parameters
(the dry-run's, or FSDP's), `use_hints(mesh, fsdp=True)` has
`transformer.forward` gather each layer's parameters as the layer starts.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

from torch.distributed.device_mesh import DeviceMesh


class MeshHints(NamedTuple):
    mesh: DeviceMesh
    data_axes: tuple[str, ...]
    model_axis: str | None
    fsdp: bool = False


_HINTS: contextvars.ContextVar[MeshHints | None] = contextvars.ContextVar(
    "repro_torch_mesh_hints", default=None)


def get_hints() -> MeshHints | None:
    return _HINTS.get()


@contextlib.contextmanager
def use_hints(mesh: DeviceMesh, fsdp: bool = False):
    """Hints for `mesh`: its "pod" and "data" dimensions are the data axes,
    its "model" dimension (if any) the model axis. Nests; the previous
    hints come back on exit.

    Inside, a plain tensor that meets a DTensor in an op is taken as
    replicated (`implicit_replication`): the model's constants (RoPE
    tables, masks, zeros) come from shapes alone, so every rank holds the
    same. Ops on plain tensors alone are not affected."""
    from torch.distributed.tensor.experimental import implicit_replication

    names = mesh.mesh_dim_names or ()
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    model_axis = "model" if "model" in names else None
    token = _HINTS.set(MeshHints(mesh, data_axes, model_axis, fsdp))
    try:
        with implicit_replication():
            yield
    finally:
        _HINTS.reset(token)
