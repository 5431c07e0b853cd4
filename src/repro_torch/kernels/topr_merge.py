"""Per-row dedup + top-r merge on the card (every pool merge and beam step).

Replaces the TPU kernel `src/repro/kernels/topr_merge.py::topr_merge_pallas`.
CUDA tensors run the hand-written kernel of `csrc/topr_merge.cu`; CPU tensors
run `ref.topr_merge_ref`.

Bound: the B*W*8 bytes in and B*r*8 out. The first port ranked each entry
by O(W^2) shared-memory comparisons and was bound by them; this kernel
sorts instead. A group of W/8 threads (rounded up to a power of two) holds
a row in registers, 8 entries a thread; a table in shared memory keeps the
first position of each id (the dedup); the live keys (distance bits,
position) of sparse rows are packed first, and a bitonic sort in registers
and warp shuffles, through shared memory only for rows wider than 256,
gives the oracle's stable order exactly. Each output slot is written once.
The 64-bit integer compares of the sort, not the bytes, bound it on an H100.

The beam merge passes `flags`, the expanded flags of the row's first F
entries (the candidates): a second instantiation of the same kernel reads
each output's flag back by the position its id and distance come from, so
the search keeps its flags without matching ids. Its launches count as
`topr_merge/flags`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P, _P, _L, _I, _I, _P, _P, _P)
_FLAG_ARGS = (_P, _P, _L, _I, _I, _P, _I, _P, _P, _P, _P)
_MAX_W = 8 * 1024  # 8 entries a thread, at most 1024 threads a row


def topr_merge(ids: torch.Tensor, dists: torch.Tensor, r: int, flags: torch.Tensor | None = None):
    """(B, W) int32 ids / fp32 dists -> (B, r) closest unique entries.

    With `flags`, a (B, F) bool tensor (F <= W) of the first F entries'
    flags, also returns the (B, r) bool flags of the output: a live slot
    takes the flag of the entry it came from (False past F), an empty slot
    True."""
    if ids.device.type == "cpu":
        return ref.topr_merge_ref(ids, dists, r, flags)
    _build.check(
        "topr_merge",
        ids.device,
        ids=(ids, torch.int32),
        dists=(dists, torch.float32),
        flags=(flags, torch.bool),
    )
    b, w = ids.shape
    bad_flags = flags is not None and (
        flags.dim() != 2 or flags.shape[0] != b or flags.shape[1] > w
    )
    if dists.shape != (b, w) or w > _MAX_W or r < 1 or bad_flags:
        shape = None if flags is None else tuple(flags.shape)
        raise ValueError(
            f"topr_merge: ids {tuple(ids.shape)}, dists {tuple(dists.shape)}, flags {shape}, r={r}"
        )
    out_i = torch.empty((b, r), dtype=torch.int32, device=ids.device)
    out_d = torch.empty((b, r), dtype=torch.float32, device=ids.device)
    stream = _build.stream_ptr(ids.device)
    if flags is None:
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
            stream,
        )
        return out_i, out_d
    out_f = torch.empty((b, r), dtype=torch.bool, device=ids.device)
    fn = _build.function("topr_merge", "topr_merge_flags_launch", _FLAG_ARGS)
    _build.launch(
        "topr_merge/flags",
        fn,
        ids.data_ptr(),
        dists.data_ptr(),
        b,
        w,
        r,
        flags.data_ptr(),
        flags.shape[1],
        out_i.data_ptr(),
        out_d.data_ptr(),
        out_f.data_ptr(),
        stream,
    )
    return out_i, out_d, out_f
