"""The staging of active requests: `pools._stage` is bitwise the
uncompacted one pass, and so is its staging over slices of destinations.

A staging first takes out its active requests (dst >= 0, and dst != src
where self-inserts are dropped), in request order, and sorts those alone:
bitwise `_rank` over the whole batch (`tests/_stage_oracle.py`), for
`_requests`' batches, with and without `drop_self`, and for batches with
no active request, only self requests or one active request; one host wait
a staging (the count), and the `pools/requests` and `pools/active` tallies
count the batch and its active requests. More active requests than
`pools.STAGE_BUDGET` are staged over ranges of destinations, one slice at a
time: the active requests to the range, in their original order (one more
host wait, for the ranges). The budgets here are forced so that the same
requests stage in one pass at the active count and in 2, 3 and 7 slices,
with inactive requests, self requests, repeated (dst, src) pairs, distance
ties, destinations past their cap, destinations with no request, a
destination with more requests than the budget and a batch with no active
request; a whole build at the `deep-small` shape is bitwise the same with
and without forced slicing.
"""

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs.grnnd_paper import DEEP_SMALL
from repro_torch.core import Draws, build_graph, pools
from repro_torch.data import synthetic
from _stage_oracle import active, one_pass

torch.set_num_threads(1)


def _requests(seed, n, m, lo_dst=0):
    """Requests with repeats of (dst, src) pairs, self requests, inactive
    ones (-1) and distance ties; destinations drawn from [lo_dst, n), a
    tenth of them on three crowded destinations (far past any cap)."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(lo_dst, n, m).astype(np.int32)
    crowd = rng.random(m) < 0.1
    dst[crowd] = rng.choice(rng.integers(lo_dst, n, 3), int(crowd.sum()))
    dst[rng.random(m) < 0.1] = -1
    src = rng.integers(0, n, m).astype(np.int32)
    dist = rng.random(m).astype(np.float32)
    dist[::5] = np.round(dist[::5], 1)
    rep = rng.random(m) < 0.3
    pick = rng.integers(0, m, int(rep.sum()))
    dst[rep], src[rep], dist[rep] = dst[pick], src[pick], dist[pick]
    self_req = rng.random(m) < 0.05
    src[self_req] = dst[self_req].clip(0)
    return torch.from_numpy(dst), torch.from_numpy(src), torch.from_numpy(dist)


def _budget_for(dst, src, n, slices, drop_self=True):
    """The largest budget under the batch's active requests (after
    `drop_self`) that stages them in `slices` slices; 1: the active count,
    the least budget that stages them in one pass."""
    dst = dst[active(dst, src, drop_self)]
    if slices == 1:
        return dst.shape[0]
    for budget in range(dst.shape[0] - 1, 0, -1):
        _, ranges = pools._slice_bounds(dst, n, budget)
        if sum(size > 0 for _, _, size in ranges) == slices:
            return budget
    raise AssertionError(f"no budget gives {slices} slices")


def _staged(dst, src, dist, n, cap, drop_self=True, budget=None):
    """(the staging, slices staged, host waits counted, {tally: count})."""
    before = trace.counts()
    out = pools._stage(dst, src, dist, n, cap, drop_self=drop_self, budget=budget)
    after = trace.counts()
    tallies = {k: after[k] - before[k] for k in ("pools/requests", "pools/active")}
    return out, after["pools/slices"] - before["pools/slices"], (
        after["host_sync/pools.stage"] - before["host_sync/pools.stage"]), tallies


def _held_to_the_oracle(dst, src, dist, n, cap, drop_self, budget=None):
    """Stage the batch, check it bitwise against the uncompacted one pass and
    its tallies against the batch: -> (slices staged, host waits counted)."""
    (gi, gd), slices, syncs, tallies = _staged(dst, src, dist, n, cap, drop_self, budget)
    wi, wd = one_pass(dst, src, dist, n, cap, drop_self)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    assert tallies == {"pools/requests": dst.shape[0],
                       "pools/active": int(active(dst, src, drop_self).sum())}
    return slices, syncs


@pytest.mark.parametrize("slices", [1, 2, 3, 7])
@pytest.mark.parametrize(
    "seed,n,m,cap,lo_dst", [(0, 60, 900, 4, 0), (1, 200, 3000, 16, 0), (2, 90, 2000, 3, 45)]
)
@pytest.mark.parametrize("drop_self", [True, False])
def test_sliced_stage_is_bitwise_the_one_pass(slices, seed, n, m, cap, lo_dst, drop_self):
    """lo_dst = 45: no request to the lower half of the destinations, so the
    first slice's range starts with destinations that get nothing."""
    dst, src, dist = _requests(seed, n, m, lo_dst)
    # under the budget: one pass, the count read
    assert _held_to_the_oracle(dst, src, dist, n, cap, drop_self) == (0, 1)
    budget = _budget_for(dst, src, n, slices, drop_self)
    assert budget < dst.shape[0]
    got = _held_to_the_oracle(dst, src, dist, n, cap, drop_self, budget)
    # as many active requests as the budget: one pass; past it the ranges read too
    assert got == ((0, 1) if slices == 1 else (slices, 2))
    wi, _ = one_pass(dst, src, dist, n, cap, drop_self)
    assert (wi >= 0).sum() > 0 and bool((wi[:, -1] >= 0).any())  # some rows fill their cap


def test_a_destination_past_the_budget_takes_a_range_alone():
    n, m = 50, 1200
    dst, src, dist = _requests(3, n, m)
    dst[: m // 2] = 17  # 600 requests, past a budget of 100
    bounds, ranges = pools._slice_bounds(dst[dst >= 0], n, 100)
    at = [lo for lo, _, _ in ranges] + [n]
    assert bounds.tolist() == at and at[0] == 0 and sorted(at) == at
    assert [size for lo, hi, size in ranges if (lo, hi) == (17, 18)][0] >= 600
    assert all(size <= 100 for lo, _, size in ranges if lo != 17)
    assert sum(size for _, _, size in ranges) == int((dst >= 0).sum())
    want = pools._stage(dst, src, dist, n, 8)
    got = pools._stage(dst, src, dist, n, 8, budget=100)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_no_active_request_stages_no_slice():
    n = 30
    dst = torch.full((500,), -1, dtype=torch.int32)
    src = torch.arange(500, dtype=torch.int32) % n
    dist = torch.rand(500)
    (ids, dists), slices, syncs, _ = _staged(dst, src, dist, n, 4, budget=100)
    assert slices == 0 and syncs == 1
    assert bool((ids == -1).all()) and bool(torch.isinf(dists).all())


def _degenerate(kind, n=40, m=600):
    g = torch.Generator().manual_seed(9)
    src = torch.randint(0, n, (m,), generator=g, dtype=torch.int32)
    dist = torch.rand(m, generator=g)
    dst = torch.full((m,), -1, dtype=torch.int32)
    if kind == "all-self":
        dst = src.clone()
    elif kind == "one-active":
        dst[m // 2] = (src[m // 2] + 1) % n
    return dst, src, dist


@pytest.mark.parametrize("kind", ["all-inactive", "all-self", "one-active"])
@pytest.mark.parametrize("drop_self", [True, False])
def test_degenerate_batches_are_bitwise_the_uncompacted_one_pass(kind, drop_self):
    """No active request (the empty buffers), only self requests (staged
    only where they are kept) and one active request: one pass, one wait."""
    dst, src, dist = _degenerate(kind)
    slices, syncs = _held_to_the_oracle(dst, src, dist, 40, 4, drop_self)
    assert slices == 0 and syncs == 1


def test_deep_small_build_is_bitwise_with_forced_slicing(monkeypatch):
    """A whole build at the deep-small shape (20,000 x 96, R = P = 24): each
    staging of its 480,000 requests in slices of destinations that hold at
    most 20,000 of its active ones (a round's redirects, a reverse round's
    requests)."""
    g = torch.Generator().manual_seed(11)
    x = synthetic.make_preset(g, "deep-like", DEEP_SMALL.n)
    cfg = DEEP_SMALL.build
    want = build_graph(x, cfg, draws=Draws(4, "cpu"), device="cpu")
    monkeypatch.setattr(pools, "STAGE_BUDGET", 20_000)
    before = trace.counts()["pools/slices"]
    got = build_graph(x, cfg, draws=Draws(4, "cpu"), device="cpu")
    stagings = cfg.t1 * cfg.t2 + cfg.t1 - 1
    assert trace.counts()["pools/slices"] - before >= 2 * stagings
    assert torch.equal(got.ids, want.ids) and torch.equal(got.dists, want.dists)
