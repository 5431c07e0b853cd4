"""One disordered GRNND propagation round on the card.

Replaces the TPU kernel `src/repro/kernels/rng_round.py::rng_round_pallas`.
CUDA tensors run the hand-written kernel of `csrc/rng_round.cu`; CPU tensors
run `ref.rng_round_ref`.

Bound: bytes. Read once, the inputs are the distinct pool rows (0.57 ms at
N = 1M fp32); but each vertex gathers its own R stored rows (24 KB at fp32,
6 KB at int8, R = 48, D = 128; 24.6 GB a round at N = 1M fp32), and those
gathered bytes, from device memory or L2, are what the kernel moves.
Design: persistent blocks of 4 warps walk the vertices with one
shared-memory row buffer each (8 blocks an SM at fp32). One warp issues a
TMA bulk copy per touched pool row of the current vertex, completing on an
mbarrier, and the next vertex's index rows one step ahead; the SM's other
blocks compute while a block waits for its rows. Four sampled pairs a warp
at once keep the first port's summation order; results are staged in
shared memory and stored by consecutive threads.

Where a vertex's R stored rows do not fit in a block's shared memory (R = 24
fp32 rows past D ~ 2,400), the direct-read instance runs instead: no row is
staged, each pair's group of 8 lanes reads its two rows from device memory
in the staged path's order, so `dij` is bitwise the same. Its launches count
as `rng_round+direct` (`rng_round/int8+direct`, ...).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _L, _I, _I, _P, _P, _P, _P, _I, _P)
_SMEM_LIMIT = 227 * 1024


def rng_round(x, ids, dists, si, sj, scale=None, offset=None, *, _direct: bool = False):
    """(dst, src, dij, kill) of one round; see `ref.rng_round_ref`.

    x (N, D) fp32, bf16 or int8 with the optional (D,) fp32 scale/offset
    dequant; ids (C, R) int32; dists (C, R) fp32; si / sj (C, P) int32 slot
    indices in [0, R). The rows are staged in shared memory where they fit
    and read directly from device memory where they do not; `_direct` forces
    the direct reads (for the tests and the kernel rows that hold the two
    paths against each other).
    """
    if x.device.type == "cpu":
        return ref.rng_round_ref(x, ids, dists, si, sj, scale, offset)
    _build.check(
        "rng_round",
        x.device,
        x=(x, _build.STORED),
        ids=(ids, torch.int32),
        dists=(dists, torch.float32),
        si=(si, torch.int32),
        sj=(sj, torch.int32),
    )
    _build.check_dequant("rng_round", x, scale, offset)
    (n, d), (c, r), p = x.shape, ids.shape, si.shape[1]
    if dists.shape != (c, r) or si.shape != (c, p) or sj.shape != (c, p):
        raise ValueError("rng_round: ids/dists must be (C, R) and si/sj (C, P)")
    smem = _build.function("rng_round", "rng_round_smem_bytes", (_I, _I, _I, _I, _I, _I))
    smem.restype = ctypes.c_longlong
    q = int(scale is not None)
    direct = _direct or smem(r, p, d, x.element_size(), q, 0) > _SMEM_LIMIT
    if direct and smem(r, p, d, x.element_size(), q, 1) > _SMEM_LIMIT:
        raise ValueError(f"rng_round: R = {r}, P = {p}, D = {d}: the index ring and the "
                         "scale / offset do not fit in shared memory")
    dev = x.device
    dst = torch.empty((c, p), dtype=torch.int32, device=dev)
    src = torch.empty((c, p), dtype=torch.int32, device=dev)
    dij = torch.empty((c, p), dtype=torch.float32, device=dev)
    kill = torch.empty((c, r), dtype=torch.bool, device=dev)
    fn = _build.function("rng_round", "rng_round_launch", _ARGS)
    _build.launch(
        _build.variant("rng_round", x.dtype) + ("+direct" if direct else ""),
        fn,
        x.data_ptr(),
        _build.DTYPE_CODES[x.dtype],
        _build.ptr(scale),
        _build.ptr(offset),
        n,
        d,
        ids.data_ptr(),
        dists.data_ptr(),
        si.data_ptr(),
        sj.data_ptr(),
        c,
        r,
        p,
        dst.data_ptr(),
        src.data_ptr(),
        dij.data_ptr(),
        kill.data_ptr(),
        int(direct),
        _build.stream_ptr(dev),
    )
    return dst, src, dij, kill
