"""Paired distances over gathered rows on the card: (M,) d(x[ni], x[nj]).

Replaces the TPU kernel `src/repro/kernels/gather_l2.py::gather_sqdist_pallas`.
CUDA tensors run the hand-written kernel of `csrc/gather_l2.cu`; CPU tensors
run `ref.gather_sqdist_ref`. Its caller on one device is the dynamic index's
constructor, which re-bases every pool edge into the traversal tier's
distance space (M = 900,000 x 48 = 43.2M pairs over a (2^20, 128) int8 tier
in `chip_smoke.py`).

Bound: bytes. Each input counted once is the store, `ni`, `nj` and the
output (~0.65 GB at that shape); the kernel reads 2*M rows (11 GB of int8
rows), most of them re-reads of rows shared between pools that L2 may
catch. Design: a group of lanes per pair, one lane per 16 B of stored row
(8 for a 128-byte int8 row, so four pairs share a warp; a warp for fp32),
reads both rows in quads (four elements in one load), dequantizes with the
scale/offset quads of the same dimensions and reduces with shuffles; no
(M, D) gather is materialized.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P, _I, _L, _I, _P, _P, _L, _P, _P, _P, _P)


def gather_sqdist(x, ni, nj, scale=None, offset=None) -> torch.Tensor:
    """(M,) fp32 squared L2 between stored rows x[ni[m]] and x[nj[m]].

    x (N, D) fp32, bf16 or int8 with the optional (D,) fp32 scale/offset
    dequant; ni / nj (M,) int32, clamped to [0, N-1]. N = 0 raises.
    """
    if x.shape[0] == 0:
        raise ValueError("gather_sqdist: the dataset has no rows to read")
    if x.device.type == "cpu":
        return ref.gather_sqdist_ref(x, ni, nj, scale, offset)
    _build.check(
        "gather_sqdist",
        x.device,
        x=(x, _build.STORED),
        ni=(ni, torch.int32),
        nj=(nj, torch.int32),
    )
    _build.check_dequant("gather_sqdist", x, scale, offset)
    (n, d), m = x.shape, ni.shape[0]
    if ni.shape != (m,) or nj.shape != (m,):
        raise ValueError("gather_sqdist: ni and nj must be (M,)")
    out = torch.empty((m,), dtype=torch.float32, device=x.device)
    fn = _build.function("gather_l2", "gather_sqdist_launch", _ARGS)
    _build.launch(
        _build.variant("gather_sqdist", x.dtype),
        fn,
        x.data_ptr(),
        _build.DTYPE_CODES[x.dtype],
        n,
        d,
        ni.data_ptr(),
        nj.data_ptr(),
        m,
        _build.ptr(scale),
        _build.ptr(offset),
        out.data_ptr(),
        _build.stream_ptr(x.device),
    )
    return out
