"""The comparisons that decide `correct`, on what the program produced.

Every function takes the program's outputs and the benchmark's own inputs
(never anything the program derived) and returns the numbers compared, by
name. The reference works the distances and neighbours out again
(`knn.py`).

  * `pool_numbers`: a built graph's pools. `pool_bad_entries` counts the
    slots that break what a pool promises (an id outside [-1, N), a
    self-edge, an id twice in a row, an empty slot without +inf or a filled
    one with it, a NaN, a row out of ascending order); `pool_dist_err` is
    the largest relative gap between a stored distance and the exact one.
  * `result_numbers`: a batch of k-NN answers. `result_bad_entries` counts
    the answers that break what a search promises (a missing or unknown id,
    an id twice for one query, distances out of order or not finite);
    `result_dist_err` is the largest relative gap between a returned
    distance and the exact one; `recall_at_10` is the share of the exact k
    nearest that came back.
"""

from __future__ import annotations

import torch

from portbench.reference import knn

TINY = 1e-12  # floor of a relative gap's denominator


def _rel_gap(got: torch.Tensor, exact: torch.Tensor, keep: torch.Tensor) -> float:
    gap = (got.double() - exact).abs() / exact.clamp_min(TINY)
    gap = torch.where(keep, gap, 0.0)
    return float(gap.max()) if gap.numel() else 0.0


def _dup_in_row(ids: torch.Tensor) -> torch.Tensor:
    """(rows, m) bool: a non-negative id that repeats an earlier one of its row
    (in sorted order)."""
    s = torch.sort(ids, dim=1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
    return dup


def _unsorted(d: torch.Tensor) -> torch.Tensor:
    bad = torch.zeros_like(d, dtype=torch.bool)
    bad[:, 1:] = d[:, 1:] < d[:, :-1]
    return bad


def pool_numbers(x: torch.Tensor, ids: torch.Tensor, dists: torch.Tensor, precision="fp64") -> dict:
    """The numbers of one built pool (ids (N, R) int32, dists (N, R) fp32)
    over the (N, D) fp32 vectors it was built from."""
    n = x.shape[0]
    rows = torch.arange(n, device=ids.device)[:, None]
    empty = ids < 0
    bad = (ids < -1) | (ids >= n) | (ids == rows)
    bad |= empty != torch.isinf(dists)
    bad |= torch.isnan(dists)
    bad |= _unsorted(dists) | _dup_in_row(ids)
    ok = ~empty & ~bad
    exact = knn.pool_sqdist(x, torch.where(ok, ids, -1), precision="fp64")
    return {
        "pool_bad_entries": int(bad.sum()),
        "pool_dist_err": _rel_gap(dists, exact, ok),
    }


def result_numbers(x, queries, ids, dists, truth) -> tuple[dict, torch.Tensor]:
    """The numbers of one batch of answers: ids (Q, k) rows of `x` (anything
    outside [0, N) is a missing or unknown answer), dists (Q, k) as
    returned, truth (Q, k) the exact nearest rows. Returns the numbers and a
    (Q,) bool of the queries with a bad entry."""
    n = x.shape[0]
    ids = ids.long()
    bad = (ids < 0) | (ids >= n)
    bad |= _dup_in_row(torch.where(bad, -1, ids))
    bad |= _unsorted(dists) | ~torch.isfinite(dists)
    ok = ~bad
    exact = knn.sqdist64(x, torch.where(ok, ids, -1), queries)
    hits = (ids[:, :, None] == truth[:, None, :].long()).any(-1) & ok
    return (
        {
            "result_bad_entries": int(bad.sum()),
            "result_dist_err": _rel_gap(dists, exact, ok),
            "recall_at_10": float(hits.sum()) / truth.numel(),
        },
        bad.any(1),
    )
