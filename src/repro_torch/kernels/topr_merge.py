"""Per-row dedup + top-r merge on the card (every pool merge and beam step).

Replaces the TPU kernel `src/repro/kernels/topr_merge.py::topr_merge_pallas`.
CUDA tensors run the hand-written kernel of `csrc/topr_merge.cu`; CPU tensors
run `ref.topr_merge_ref`.

Bound: the O(W^2) shared-memory comparisons per row (W = 96 in the build,
ef + R in search), not the B*W*8 bytes in and B*r*8 out. Design: one block
per row; an entry's output slot is its rank in (distance, position) order
among the deduplicated survivors, so each slot is written once and the
integers match the oracle's stable sort exactly.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P, _P, _L, _I, _I, _P, _P, _P)
_MAX_W = 48 * 1024 // 8  # the row must fit the default 48 KB of shared memory


def topr_merge(ids: torch.Tensor, dists: torch.Tensor, r: int):
    """(B, W) int32 ids / fp32 dists -> (B, r) closest unique entries."""
    if ids.device.type == "cpu":
        return ref.topr_merge_ref(ids, dists, r)
    _build.check("topr_merge", ids.device, ids=(ids, torch.int32), dists=(dists, torch.float32))
    b, w = ids.shape
    if dists.shape != (b, w) or w > _MAX_W or r < 1:
        raise ValueError(f"topr_merge: ids {tuple(ids.shape)}, dists {tuple(dists.shape)}, r={r}")
    out_i = torch.empty((b, r), dtype=torch.int32, device=ids.device)
    out_d = torch.empty((b, r), dtype=torch.float32, device=ids.device)
    fn = _build.function("topr_merge", "topr_merge_launch", _ARGS)
    _build.launch(
        "topr_merge",
        fn,
        ids.data_ptr(),
        dists.data_ptr(),
        b,
        w,
        r,
        out_i.data_ptr(),
        out_d.data_ptr(),
        _build.stream_ptr(ids.device),
    )
    return out_i, out_d
