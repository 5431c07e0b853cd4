"""Ground-truth kNN (brute force, chunked over queries) and Recall@k."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.kernels import ops


def brute_force_knn(x, queries, k: int, chunk: int = 1024, device="cuda") -> torch.Tensor:
    """Exact k nearest dataset rows per query (squared L2) -> (Q, k) int32.

    Ties at equal distance come back in `torch.topk`'s order, which is not
    promised to be the lower index first; recall compares sets.
    """
    dev = _device.resolve(device)
    x = _device.put(x, torch.float32, dev)
    queries = _device.put(queries, torch.float32, dev)
    outs = []
    for lo in range(0, queries.shape[0], chunk):
        d = ops.pairwise_sqdist(queries[lo : lo + chunk], x)
        outs.append(torch.topk(d, k, dim=-1, largest=False).indices)
    return torch.cat(outs).to(torch.int32)


def recall_at_k(found_ids, true_ids) -> float:
    """Fraction of true k-NN retrieved (order-insensitive). found (Q,k), true (Q,k)."""
    f = np.asarray(torch.as_tensor(found_ids).cpu())
    t = np.asarray(torch.as_tensor(true_ids).cpu())
    hits = 0
    for row_f, row_t in zip(f, t):
        hits += len(set(row_f[row_f >= 0].tolist()) & set(row_t.tolist()))
    return hits / t.size
