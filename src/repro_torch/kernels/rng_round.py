"""One disordered GRNND propagation round on the card.

Replaces the TPU kernel `src/repro/kernels/rng_round.py::rng_round_pallas`.
CUDA tensors run the hand-written kernel of `csrc/rng_round.cu`; CPU tensors
run `ref.rng_round_ref`.

Bound: per vertex, the R*D*4 bytes of its pool rows (24 KB at R = 48,
D = 128; about 25 GB a round at N = 1M, mostly re-reads of rows shared
between pools). Design: one block per vertex copies its R rows into shared
memory once, as the TPU kernel keeps them in VMEM, so each of the P sampled
pairs reads shared memory instead of device memory; one warp per pair
reduces with shuffles, and the kill mask is an order-free flag per slot.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P, _I, _I, _P, _P, _P, _P, _L, _I, _I, _P, _P, _P, _P, _P)
_SMEM_LIMIT = 227 * 1024


def rng_round(x, ids, dists, si, sj):
    """(dst, src, dij, kill) of one round; see `ref.rng_round_ref`.

    x (N, D) fp32; ids (C, R) int32; dists (C, R) fp32; si / sj (C, P) int32
    slot indices in [0, R).
    """
    if x.device.type == "cpu":
        return ref.rng_round_ref(x, ids, dists, si, sj)
    _build.check(
        "rng_round",
        x.device,
        x=(x, torch.float32),
        ids=(ids, torch.int32),
        dists=(dists, torch.float32),
        si=(si, torch.int32),
        sj=(sj, torch.int32),
    )
    (n, d), (c, r), p = x.shape, ids.shape, si.shape[1]
    if dists.shape != (c, r) or si.shape != (c, p) or sj.shape != (c, p):
        raise ValueError("rng_round: ids/dists must be (C, R) and si/sj (C, P)")
    if r * d * 4 + r * 4 > _SMEM_LIMIT:
        raise ValueError(f"rng_round: R*D = {r}*{d} rows do not fit in shared memory")
    dev = x.device
    dst = torch.empty((c, p), dtype=torch.int32, device=dev)
    src = torch.empty((c, p), dtype=torch.int32, device=dev)
    dij = torch.empty((c, p), dtype=torch.float32, device=dev)
    kill = torch.empty((c, r), dtype=torch.bool, device=dev)
    fn = _build.function("rng_round", "rng_round_launch", _ARGS)
    _build.launch(
        "rng_round",
        fn,
        x.data_ptr(),
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
        _build.stream_ptr(dev),
    )
    return dst, src, dij, kill
