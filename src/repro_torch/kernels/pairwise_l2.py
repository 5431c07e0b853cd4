"""Squared L2 distances on the card: all pairs and corresponding rows.

`pairwise_sqdist` replaces the TPU kernel
`src/repro/kernels/pairwise_l2.py::pairwise_sqdist_pallas`; `rowwise_sqdist`
replaces `src/repro/kernels/pairwise_l2.py::rowwise_sqdist_pallas`. Both run
the hand-written CUDA kernels of `csrc/pairwise_l2.cu` for CUDA tensors and
the plain versions in `ref.py` for CPU tensors.

pairwise: bound by its 2*M*N*D fp32 FMAs at the ground-truth shapes (1024
queries x 1M rows x 128). For M > 4 the kernel is a pipelined register-tiled
GEMM on the FMA units (no TF32, no library GEMM): 128x256 output tiles of
256 threads, 8x16 a thread, one persistent block an SM, K-slabs of 32
through a ring of four shared-memory stages fed by 16-byte `cp.async` copies
(fp32 rows) or register loads (bf16 / int8 rows, dequantized on the way: the
medoid and ground truth of the dynamic index read its int8 tier this way),
the norms summed once a block, and 16-byte streaming stores. For M <= 4 (the
medoid's M = 1) a row-streaming kernel holds the queries in shared memory
and is bound by the N*D stored bytes of y. rowwise: bound by its 2*M*D*4
input bytes; one warp per row pair with float4 loads.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PAIRWISE_ARGS = (_P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _I, _P, _P)
_ROWWISE_ARGS = (_P, _P, _L, _I, _P, _P)
_MAX_M = 2**31 - 1  # M is a C int; the persistent grid sets no limit of its own


def pairwise_sqdist(
    x: torch.Tensor,
    y: torch.Tensor,
    x_scale=None,
    x_offset=None,
    y_scale=None,
    y_offset=None,
) -> torch.Tensor:
    """(M, D) x (N, D) -> (M, N) fp32 max(|x|^2 + |y|^2 - 2 x.y, 0).

    Each side is fp32, bf16 or int8, with its optional (D,) fp32 dequant."""
    if x.device.type == "cpu":
        return ref.pairwise_sqdist_ref(x, y, x_scale, x_offset, y_scale, y_offset)
    _build.check("pairwise_sqdist", x.device, x=(x, _build.STORED), y=(y, _build.STORED))
    _build.check_dequant("pairwise_sqdist", x, x_scale, x_offset)
    _build.check_dequant("pairwise_sqdist", y, y_scale, y_offset)
    (m, d), (n, d2) = x.shape, y.shape
    if d != d2 or m > _MAX_M:
        raise ValueError(f"pairwise_sqdist: shapes {tuple(x.shape)} x {tuple(y.shape)}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _build.function("pairwise_l2", "pairwise_sqdist_launch", _PAIRWISE_ARGS)
    _build.launch(
        _build.variant("pairwise_sqdist", x.dtype, y.dtype),
        fn,
        x.data_ptr(),
        _build.DTYPE_CODES[x.dtype],
        _build.ptr(x_scale),
        _build.ptr(x_offset),
        y.data_ptr(),
        _build.DTYPE_CODES[y.dtype],
        _build.ptr(y_scale),
        _build.ptr(y_offset),
        m,
        n,
        d,
        out.data_ptr(),
        _build.stream_ptr(x.device),
    )
    return out


def rowwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, D) x (M, D) fp32 -> (M,) fp32 squared L2 of corresponding rows."""
    if x.device.type == "cpu":
        return ref.rowwise_sqdist_ref(x, y)
    _build.check("rowwise_sqdist", x.device, x=(x, torch.float32), y=(y, torch.float32))
    if x.shape != y.shape or x.dim() != 2:
        raise ValueError(f"rowwise_sqdist: shapes {tuple(x.shape)} and {tuple(y.shape)}")
    m, d = x.shape
    out = torch.empty((m,), dtype=torch.float32, device=x.device)
    fn = _build.function("pairwise_l2", "rowwise_sqdist_launch", _ROWWISE_ARGS)
    _build.launch(
        "rowwise_sqdist",
        fn,
        x.data_ptr(),
        y.data_ptr(),
        m,
        d,
        out.data_ptr(),
        _build.stream_ptr(x.device),
    )
    return out
