"""The plain reference: exact nearest neighbours and exact squared distances.

Plain PyTorch. It imports nothing of the program and takes nothing the
program made: it is handed the vectors and queries the benchmark drew, and
works out the neighbours and distances again.

  * `exact_knn`: candidates by an fp32 product (TF32 off) in blocks of
    queries, re-ranked by exact float64 distances, so the k it returns are
    the true k nearest unless an fp32 rounding moved a true neighbour past
    `extra` others;
  * `sqdist64`: float64 squared distances of given (query, row) pairs;
  * the `*_bf16` twins compute the same in bfloat16. They are the control:
    the reference in the program's place at the precision below the
    program's fp32, which the comparison must refuse.
"""

from __future__ import annotations

import contextlib

import torch

QUERY_BLOCK = 1024  # queries per block of the (block, N) candidate matrix
PAIR_ELEMS = 1 << 27  # gathered elements per block of a distance pass


@contextlib.contextmanager
def full_fp32():
    """TF32 off for the products inside, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _pair_blocks(n_rows: int, per_row: int, d: int) -> int:
    return max(1, PAIR_ELEMS // max(per_row * d, 1))


def sqdist64(x: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(Q, m) float64 squared distances between each query and the rows
    `ids` (Q, m) of `x`; ids < 0 give +inf."""
    q, m = ids.shape
    out = torch.empty((q, m), dtype=torch.float64, device=ids.device)
    step = _pair_blocks(q, m, x.shape[1])
    for lo in range(0, q, step):
        i = ids[lo : lo + step]
        rows = x[i.clamp_min(0).long()].double()
        d = (rows - queries[lo : lo + step, None, :].double()).square().sum(-1)
        out[lo : lo + step] = torch.where(i >= 0, d, torch.inf)
    return out


def sqdist_bf16(x: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """`sqdist64` computed in bfloat16 (returned as float64)."""
    q, m = ids.shape
    out = torch.empty((q, m), dtype=torch.float64, device=ids.device)
    step = _pair_blocks(q, m, x.shape[1])
    for lo in range(0, q, step):
        i = ids[lo : lo + step]
        rows = x[i.clamp_min(0).long()].bfloat16()
        d = (rows - queries[lo : lo + step, None, :].bfloat16()).square().sum(-1)
        out[lo : lo + step] = torch.where(i >= 0, d.double(), torch.inf)
    return out


def _knn(x, queries, k, live, extra, dtype, dist):
    n = x.shape[0]
    n_live = n if live is None else int(live.sum())
    if n_live < k:
        raise ValueError(f"exact_knn needs at least k={k} live rows, got {n_live}")
    m = min(k + extra, n_live)
    xs = x.to(dtype)
    xn = (xs * xs).sum(1)
    ids_out, d_out = [], []
    with full_fp32():
        for lo in range(0, queries.shape[0], QUERY_BLOCK):
            qb = queries[lo : lo + QUERY_BLOCK]
            qs = qb.to(dtype)
            approx = (qs * qs).sum(1)[:, None] + xn[None, :] - 2.0 * (qs @ xs.T)
            if live is not None:
                approx.masked_fill_(~live[None, :], torch.inf)
            cand = approx.topk(m, dim=1, largest=False).indices
            del approx
            d = dist(x, cand, qb)
            order = torch.sort(d, dim=1, stable=True).indices[:, :k]
            ids_out.append(cand.gather(1, order))
            d_out.append(d.gather(1, order))
    return torch.cat(ids_out), torch.cat(d_out)


def exact_knn(x, queries, k: int, live=None, extra: int = 16):
    """The k nearest rows of `x` (N, D) fp32 to each of `queries` (Q, D):
    (ids (Q, k) int64, squared distances (Q, k) float64), nearest first.
    `live` (N,) bool keeps only those rows."""
    return _knn(x, queries, k, live, extra, torch.float32, sqdist64)


def exact_knn_bf16(x, queries, k: int, live=None, extra: int = 16):
    """`exact_knn` with the candidates and distances in bfloat16: the
    control."""
    return _knn(x, queries, k, live, extra, torch.bfloat16, sqdist_bf16)


def pool_sqdist(x: torch.Tensor, ids: torch.Tensor, precision: str = "fp64") -> torch.Tensor:
    """(N, R) squared distances between each row v of `x` and the rows
    `ids[v]`, in float64 (`"fp64"`) or bfloat16 (`"bf16"`, the control),
    returned as float64; ids < 0 give +inf."""
    n, r = ids.shape
    dist = sqdist64 if precision == "fp64" else sqdist_bf16
    out = torch.empty((n, r), dtype=torch.float64, device=ids.device)
    step = _pair_blocks(n, r, x.shape[1])
    for lo in range(0, n, step):
        out[lo : lo + step] = dist(x, ids[lo : lo + step], x[lo : lo + step])
    return out
