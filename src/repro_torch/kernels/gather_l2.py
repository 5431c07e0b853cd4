"""Paired distances over gathered rows on the card: (M,) d(x[ni], x[nj]).

Replaces the TPU kernel `src/repro/kernels/gather_l2.py::gather_sqdist_pallas`.
CUDA tensors run the hand-written kernel of `csrc/gather_l2.cu`; CPU tensors
run `ref.gather_sqdist_ref`. Its caller on one device is the dynamic index's
constructor, which re-bases every pool edge into the traversal tier's
distance space (M = 900,000 x 48 = 43.2M pairs, `ni` in runs of 48 equal
owners, over the int8 or bf16 tier of the n = 10^6 corpus in
`chip_smoke.py`).

Bound: bf16 by its gathered neighbor rows (11 GB, 3.53 ms from device
memory; it reads 2.99 ms, L2 serving some). int8 reads 3.03 ms against
1.84 ms of rows: the latency between a batch's row loads and its sums.
Design: persistent lane groups (one lane per 16 B of stored row) walk
contiguous pair ranges, four pairs a batch, all rows of a batch loaded
before any is summed; the owner row is dequantized once a run of equal
`ni` and kept in shared memory beside the scale / offset; the groups of a
warp step together. Each pair is summed in the order of the kernel PR 12
shipped, so the output is bitwise that kernel's.
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
