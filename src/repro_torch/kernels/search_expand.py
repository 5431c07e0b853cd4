"""One beam-search expansion step on the card.

Replaces the TPU kernel `src/repro/kernels/search_expand.py::search_expand_pallas`
in its fp32, unfiltered variant without the tombstone mask. CUDA tensors run
the hand-written kernel of `csrc/search_expand.cu`; CPU tensors run
`ref.search_expand_ref`.

Bound: the Q*R*D*4 bytes of scattered neighbor rows a step reads (245 MB at
Q = 10,000, R = 48, D = 128). Design: one block per query with the query in
shared memory; one warp per neighbor reads its row once as float4s and
reduces with shuffles, while eight lanes probe the visited table's window
and a ballot gives `fresh`. Empty slots read no row.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P, _I, _I, _P, _P, _L, _I, _P, _I, _P, _P, _P, _P)


def search_expand(x, queries, nbrs, table):
    """(ids, dists, fresh) of one expansion step; see `ref.search_expand_ref`.

    x (N, D) fp32; queries (Q, D) fp32; nbrs (Q, R) int32; table (Q, H) int32.
    """
    if x.device.type == "cpu":
        return ref.search_expand_ref(x, queries, nbrs, table)
    _build.check(
        "search_expand",
        x.device,
        x=(x, torch.float32),
        queries=(queries, torch.float32),
        nbrs=(nbrs, torch.int32),
        table=(table, torch.int32),
    )
    (n, d), (q, r), h = x.shape, nbrs.shape, table.shape[1]
    if queries.shape != (q, d) or table.shape[0] != q or h < 1:
        raise ValueError("search_expand: queries must be (Q, D) and table (Q, H)")
    dev = x.device
    out_i = torch.empty((q, r), dtype=torch.int32, device=dev)
    out_d = torch.empty((q, r), dtype=torch.float32, device=dev)
    fresh = torch.empty((q, r), dtype=torch.bool, device=dev)
    fn = _build.function("search_expand", "search_expand_launch", _ARGS)
    _build.launch(
        "search_expand",
        fn,
        x.data_ptr(),
        n,
        d,
        queries.data_ptr(),
        nbrs.data_ptr(),
        q,
        r,
        table.data_ptr(),
        h,
        out_i.data_ptr(),
        out_d.data_ptr(),
        fresh.data_ptr(),
        _build.stream_ptr(dev),
    )
    return out_i, out_d, fresh
