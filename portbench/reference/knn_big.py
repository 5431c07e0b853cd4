"""The plain reference's exact k-NN at any corpus size.

`knn.exact_knn` forms a (1024, N) fp32 candidate matrix a block of queries,
and its expression makes three: 41 GB each at N = 10^7. Here the block of
queries is sized from N, so that the candidate matrix and the one product
beside it stay under `CAND_ELEMS` elements at any N. The arithmetic is
`knn`'s, operation for operation (fp32 candidates, TF32 off, re-ranked by
float64 distances; the control in bfloat16), so both give the same
neighbours and distances. Plain PyTorch; it imports nothing of the program.
"""

from __future__ import annotations

import torch

from portbench.reference import knn

CAND_ELEMS = 1 << 30  # elements of one (block, N) matrix: 4 GiB in fp32


def query_block(n: int, budget: int = CAND_ELEMS) -> int:
    """Queries a block: as many as keep a (block, n) matrix under `budget`
    elements, at most `knn.QUERY_BLOCK`."""
    return max(1, min(knn.QUERY_BLOCK, budget // max(n, 1)))


def _knn(x, queries, k, extra, dtype, dist, block):
    n = x.shape[0]
    if n < k:
        raise ValueError(f"exact_knn needs at least k={k} rows, got {n}")
    m = min(k + extra, n)
    xs = x.to(dtype)
    xn = (xs * xs).sum(1)
    step = query_block(n) if block is None else block
    ids_out, d_out = [], []
    with knn.full_fp32():
        for lo in range(0, queries.shape[0], step):
            qb = queries[lo : lo + step]
            qs = qb.to(dtype)
            # knn's (q·q + x·x) - 2 (q @ x.T) with one matrix less alive:
            # 2·p is exact, so a - 2·p rounds as knn's a - (2.0 * p) does
            approx = (qs * qs).sum(1)[:, None] + xn[None, :]
            approx.sub_(qs @ xs.T, alpha=2.0)
            cand = approx.topk(m, dim=1, largest=False).indices
            del approx
            d = dist(x, cand, qb)
            order = torch.sort(d, dim=1, stable=True).indices[:, :k]
            ids_out.append(cand.gather(1, order))
            d_out.append(d.gather(1, order))
    return torch.cat(ids_out), torch.cat(d_out)


def exact_knn(x, queries, k: int, extra: int = 16, block: int | None = None):
    """`knn.exact_knn` (no `live` mask) in blocks of `block` queries
    (default `query_block(N)`): (ids (Q, k) int64, squared distances (Q, k)
    float64), nearest first."""
    return _knn(x, queries, k, extra, torch.float32, knn.sqdist64, block)


def exact_knn_bf16(x, queries, k: int, extra: int = 16, block: int | None = None):
    """`exact_knn` with the candidates and distances in bfloat16: the
    control."""
    return _knn(x, queries, k, extra, torch.bfloat16, knn.sqdist_bf16, block)
