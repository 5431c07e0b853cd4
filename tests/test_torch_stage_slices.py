"""The bounded staging: `pools._stage` over slices of destinations is bitwise
the one-pass staging.

A staging of more requests than `pools.STAGE_BUDGET` is staged over
ranges of destinations, one slice at a time: the requests to the range, in
their original order (an inactive request is in none). The budgets here are
forced so that the same requests stage in 1, 2, 3 and 7 slices, with
inactive requests, self requests,
repeated (dst, src) pairs, distance ties, destinations past their cap,
destinations with no request, a destination with more requests than the
budget and a batch with no active request; a whole build at the
`deep-small` shape is bitwise the same with and without forced slicing.
"""

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs.grnnd_paper import DEEP_SMALL
from repro_torch.core import Draws, build_graph, pools
from repro_torch.data import synthetic

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


def _budget_for(dst, n, slices):
    """The largest budget under the batch's size that stages `dst` in
    `slices` slices."""
    active = int((dst >= 0).sum())
    if slices == 1:
        return active
    for budget in range(active - 1, 0, -1):
        _, ranges = pools._slice_bounds(dst, n, budget)
        if sum(size > 0 for _, _, size in ranges) == slices:
            return budget
    raise AssertionError(f"no budget gives {slices} slices")


def _staged(dst, src, dist, n, cap, drop_self=True, budget=None):
    before = trace.counts()
    out = pools._stage(dst, src, dist, n, cap, drop_self=drop_self, budget=budget)
    after = trace.counts()
    return out, after["pools/slices"] - before["pools/slices"], (
        after["host_sync/pools.stage"] - before["host_sync/pools.stage"])


@pytest.mark.parametrize("slices", [1, 2, 3, 7])
@pytest.mark.parametrize(
    "seed,n,m,cap,lo_dst", [(0, 60, 900, 4, 0), (1, 200, 3000, 16, 0), (2, 90, 2000, 3, 45)]
)
@pytest.mark.parametrize("drop_self", [True, False])
def test_sliced_stage_is_bitwise_the_one_pass(slices, seed, n, m, cap, lo_dst, drop_self):
    """lo_dst = 45: no request to the lower half of the destinations, so the
    first slice's range starts with destinations that get nothing."""
    dst, src, dist = _requests(seed, n, m, lo_dst)
    (wi, wd), one, syncs = _staged(dst, src, dist, n, cap, drop_self)
    assert one == 0 and syncs == 0  # under the budget: one pass, no host read
    budget = _budget_for(dst, n, slices)
    assert budget < dst.shape[0]
    (gi, gd), got, syncs = _staged(dst, src, dist, n, cap, drop_self, budget)
    assert got == slices and syncs == 1  # the ranges read
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    assert (wi >= 0).sum() > 0 and bool((wi[:, -1] >= 0).any())  # some rows fill their cap


def test_a_destination_past_the_budget_takes_a_range_alone():
    n, m = 50, 1200
    dst, src, dist = _requests(3, n, m)
    dst[: m // 2] = 17  # 600 requests, past a budget of 100
    bounds, ranges = pools._slice_bounds(dst, n, 100)
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
    (ids, dists), slices, syncs = _staged(dst, src, dist, n, 4, budget=100)
    assert slices == 0 and syncs == 1
    assert bool((ids == -1).all()) and bool(torch.isinf(dists).all())


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
