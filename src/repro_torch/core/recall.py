"""Ground-truth kNN (brute force, chunked over queries), Recall@k, and the
distance excess of found neighbors over the true ones."""

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


def distance_excess(x, queries, found_ids, true_ids, rand_ids) -> float:
    """How near the found rows came, where recall by ids may read ~0.

    The mean over queries of (f - t) / (r - t), where f, t and r are a
    query's mean squared distance to its found, true and random rows of `x`
    ((Q, k) ids each; found ids < 0 are left out): 0 when the found rows
    are as near as the true ones, ~1 when no nearer than random rows.
    """
    x = torch.as_tensor(x)
    q = torch.as_tensor(queries, dtype=torch.float32, device=x.device)

    def mean_sqdist(ids):
        ids = torch.as_tensor(ids, device=x.device)
        live = (ids >= 0).float()
        d = ((x[ids.clamp_min(0).long()].float() - q[:, None, :]) ** 2).sum(-1)
        return (d * live).sum(1) / live.sum(1)

    f, t, r = mean_sqdist(found_ids), mean_sqdist(true_ids), mean_sqdist(rand_ids)
    return float(((f - t) / (r - t)).mean())


def pool_excess(x, vertices, pool_ids, true_ids, rand_ids) -> float:
    """`distance_excess` of each vertex's nearest pool members (by fp32
    distance, as many as `true_ids` has columns; ids < 0 left out) over its
    true neighbors: how near a graph's pools came."""
    x = torch.as_tensor(x)
    vertices = torch.as_tensor(vertices, device=x.device).long()
    ids = torch.as_tensor(pool_ids, device=x.device)[vertices]
    d = ((x[ids.clamp_min(0).long()].float() - x[vertices][:, None, :].float()) ** 2).sum(-1)
    top = torch.topk(d.masked_fill(ids < 0, torch.inf), true_ids.shape[1], dim=1, largest=False)
    near = torch.where(torch.isfinite(top.values), ids.gather(1, top.indices), -1)
    return distance_excess(x, x[vertices], near, true_ids, rand_ids)
