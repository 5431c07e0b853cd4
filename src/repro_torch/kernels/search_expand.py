"""One beam-search expansion step on the card.

Replaces the TPU kernel `src/repro/kernels/search_expand.py::search_expand_pallas`
with its storage variants (fp32, bf16, int8 with the per-dimension dequant),
its `valid` tombstone mask and its filter variant (the label predicate of
filtered search). CUDA tensors run the hand-written kernel of
`csrc/search_expand.cu`; CPU tensors run `ref.search_expand_ref`.

Bound: the bytes a step must move, counting each stored neighbor row once
however many queries share it (the unique rows of `nbrs`, as `chip_smoke.py`
counts them: 0.040 ms at fp32, Q = 10,000, R = 48, D = 128 on the SIFT1M
shape), plus the ids, the probed table slots, the label words with the
filter, and the outputs. Each neighbor is a chain of dependent loads
(id, then valid byte, table window and label words, then the row), so the
design puts each query's loads of one kind in flight together: one block
per query. Its threads read the R
ids and valid bytes at once, coalesced; after one barrier lane groups (a
warp per fp32 row, one lane per 16 B of stored row on the quantized rungs)
issue 16-byte async copies of all live rows into shared memory (rows of a
multiple of 16 B, up to 32 KB a block; other rows are read directly), and
while they fly each live neighbor's thread issues its 8-slot table window
and label words together and writes `fresh` and `allowed`; the groups then
sum each row in the order of the kernel it replaced, so dists stay bitwise,
and the distances go out through shared memory, written by consecutive
threads. A dead neighbor (id < 0, or tombstoned by `valid`) reads no row
and comes out as an empty slot. With the filter, `allowed` is
the AND of the neighbor's W label words with the query's predicate words;
ids, dists and fresh are those of the unfiltered step (route-through).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P, _I, _P, _P, _I, _I, _P, _P, _L, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P)


def search_expand(
    x, queries, nbrs, table, valid=None, scale=None, offset=None, vwords=None, fwords=None
):
    """(ids, dists, fresh[, allowed]) of one expansion step; see
    `ref.search_expand_ref`.

    x (N, D) fp32, bf16 or int8 with the optional (D,) fp32 scale/offset
    dequant; queries (Q, D) fp32; nbrs (Q, R) int32; table (Q, H) int32;
    valid: None or the (N,) bool tombstone mask; vwords (N, W) / fwords
    (Q, W) int32: the label predicate, both or neither (with them a fourth
    output, `allowed` (Q, R) bool).
    """
    if (vwords is None) != (fwords is None):
        raise ValueError("search_expand: give both vwords and fwords, or neither")
    if x.device.type == "cpu":
        return ref.search_expand_ref(
            x, queries, nbrs, table, valid, scale, offset, vwords, fwords
        )
    _build.check(
        "search_expand",
        x.device,
        x=(x, _build.STORED),
        queries=(queries, torch.float32),
        nbrs=(nbrs, torch.int32),
        table=(table, torch.int32),
        valid=(valid, torch.bool),
        vwords=(vwords, torch.int32),
        fwords=(fwords, torch.int32),
    )
    _build.check_dequant("search_expand", x, scale, offset)
    (n, d), (q, r), h = x.shape, nbrs.shape, table.shape[1]
    if queries.shape != (q, d) or table.shape[0] != q or h < 1:
        raise ValueError("search_expand: queries must be (Q, D) and table (Q, H)")
    if valid is not None and valid.shape != (n,):
        raise ValueError(f"search_expand: valid must be ({n},)")
    filtered = vwords is not None
    w = vwords.shape[1] if filtered else 0
    if filtered and (vwords.shape != (n, w) or fwords.shape != (q, w) or w < 1):
        raise ValueError(f"search_expand: vwords must be ({n}, W) and fwords ({q}, W), W >= 1")
    dev = x.device
    out_i = torch.empty((q, r), dtype=torch.int32, device=dev)
    out_d = torch.empty((q, r), dtype=torch.float32, device=dev)
    fresh = torch.empty((q, r), dtype=torch.bool, device=dev)
    allowed = torch.empty((q, r), dtype=torch.bool, device=dev) if filtered else None
    fn = _build.function("search_expand", "search_expand_launch", _ARGS)
    _build.launch(
        _build.variant("search_expand", x.dtype, valid=valid is not None, filter=filtered),
        fn,
        x.data_ptr(),
        _build.DTYPE_CODES[x.dtype],
        _build.ptr(scale),
        _build.ptr(offset),
        n,
        d,
        queries.data_ptr(),
        nbrs.data_ptr(),
        q,
        r,
        table.data_ptr(),
        h,
        _build.ptr(valid),
        _build.ptr(vwords),
        _build.ptr(fwords),
        w,
        out_i.data_ptr(),
        out_d.data_ptr(),
        fresh.data_ptr(),
        _build.ptr(allowed),
        _build.stream_ptr(dev),
    )
    return (out_i, out_d, fresh, allowed) if filtered else (out_i, out_d, fresh)
