"""repro_torch.core.pools against repro.core.pools on identical requests.

Staging is pure integer work on identical (dst, src, dist) inputs: the
staged ids and dists must equal the reference's exactly, including
duplicate requests, self requests, inactive requests and capacity
overflow; so must the staging at a forced `pools.STAGE_BUDGET` (counted
in active requests): in one pass at a budget of every request with dst >= 0,
under the batch's size, or in several slices of destinations. Merges go through `topr_merge`, whose integers are exact too.
`init_random` is fed the reference's own raw draws; its distances are fp32
sums in another order (rtol 1e-5), and its ids must be equal except where
two of a row's distances tie within that tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pools as jpools
from repro_torch import trace
from repro_torch.core import pools
from repro_torch.core.draws import RecordedDraws

# the suite runs in parallel workers: one intra-op thread each keeps torch
# from oversubscribing the cores the JAX tests share
torch.set_num_threads(1)


# the reference, jitted: eager JAX compiles every op anew per shape
_stage_ref = jax.jit(jpools.stage_request_matrix, static_argnums=(3, 4))
_group_ref = jax.jit(jpools.group_requests, static_argnums=(1, 2, 3))
_insert_ref = jax.jit(jpools.insert_requests, static_argnums=(2,))
_into_empty_ref = jax.jit(jpools.build_requests_into_empty, static_argnums=(0, 1, 3))
_init_ref = jax.jit(jpools.init_random, static_argnums=(2, 3))
_merge_ref = jax.jit(jpools.merge_into)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _requests(seed, n, m, dup_frac=0.3):
    """Random requests with repeats of (dst, src) pairs, self requests,
    inactive ones (-1) and distance ties."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(-1, n, m).astype(np.int32)
    src = rng.integers(0, n, m).astype(np.int32)
    dist = rng.random(m).astype(np.float32)
    dist[::5] = np.round(dist[::5], 1)
    rep = rng.random(m) < dup_frac
    k = int(rep.sum())
    pick = rng.integers(0, m, k)
    dst[rep], src[rep] = dst[pick], src[pick]
    self_req = rng.random(m) < 0.05
    src[self_req] = dst[self_req].clip(0)
    return dst, src, dist


STAGE_CASES = [(0, 40, 6, 4), (1, 64, 16, 16), (2, 30, 24, 3), (3, 128, 8, 32)]


def _force_slices(monkeypatch, dst, slices):
    """Set `pools.STAGE_BUDGET` under the batch's size: "one", every request
    with dst >= 0, so that the active requests stage in one pass; or
    "several", a quarter of that, so that they stage in slices; -> the
    `pools/slices` count before."""
    active = int((dst >= 0).sum())
    assert 10 < active < dst.size
    monkeypatch.setattr(pools, "STAGE_BUDGET", active if slices == "one" else active // 4)
    return trace.counts()["pools/slices"]


def _slices_since(before, slices, stagings=1):
    got = trace.counts()["pools/slices"] - before
    assert got == 0 if slices == "one" else got > stagings


def _stage_equals_reference(seed, n, p, cap):
    dst, src, dist = (a.reshape(n, p) for a in _requests(seed, n, n * p))
    gi, gd = pools.stage_request_matrix(_t(dst), _t(src), _t(dist), n, cap)
    wi, wd = _stage_ref(dst, src, dist, n, cap)
    assert gi.shape == (n, cap) and gi.dtype == torch.int32 and gd.dtype == torch.float32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("seed,n,p,cap", STAGE_CASES)
def test_stage_request_matrix_equals_reference_exactly(seed, n, p, cap):
    _stage_equals_reference(seed, n, p, cap)


@pytest.mark.parametrize("slices", ["one", "several"])
@pytest.mark.parametrize("seed,n,p,cap", STAGE_CASES)
def test_stage_request_matrix_in_slices_equals_reference_exactly(
        seed, n, p, cap, slices, monkeypatch):
    before = _force_slices(monkeypatch, _requests(seed, n, n * p)[0], slices)
    _stage_equals_reference(seed, n, p, cap)
    _slices_since(before, slices)


def _group_equals_reference(drop_self):
    dst, src, dist = _requests(7, 50, 700)
    req = pools.Requests(_t(dst), _t(src), _t(dist))
    jreq = jpools.Requests(jnp.asarray(dst), jnp.asarray(src), jnp.asarray(dist))
    gi, gd = pools.group_requests(req, 50, 8, drop_self=drop_self)
    wi, wd = _group_ref(jreq, 50, 8, drop_self)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("drop_self", [True, False])
def test_group_requests_equals_reference_exactly(drop_self):
    _group_equals_reference(drop_self)


@pytest.mark.parametrize("slices", ["one", "several"])
@pytest.mark.parametrize("drop_self", [True, False])
def test_group_requests_in_slices_equals_reference_exactly(drop_self, slices, monkeypatch):
    before = _force_slices(monkeypatch, _requests(7, 50, 700)[0], slices)
    _group_equals_reference(drop_self)
    _slices_since(before, slices)


def _pool(seed, n, r):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, n, (n, r)).astype(np.int32)
    dists = np.sort(rng.random((n, r)).astype(np.float32), axis=1)
    dists[ids < 0] = np.inf
    return ids, dists


def _insert_and_into_empty_equal_reference():
    n, r = 48, 8
    ids, dists = _pool(11, n, r)
    dst, src, dist = _requests(12, n, 400)
    req = pools.Requests(_t(dst), _t(src), _t(dist))
    jreq = jpools.Requests(jnp.asarray(dst), jnp.asarray(src), jnp.asarray(dist))
    got = pools.insert_requests(pools.Pool(_t(ids), _t(dists)), req, cap=6)
    want = _insert_ref(jpools.Pool(jnp.asarray(ids), jnp.asarray(dists)), jreq, 6)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))
    got = pools.build_requests_into_empty(n, r, req, cap=4)
    want = _into_empty_ref(n, r, jreq, 4)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))


def test_insert_requests_and_build_into_empty_equal_reference():
    _insert_and_into_empty_equal_reference()


@pytest.mark.parametrize("slices", ["one", "several"])
def test_insert_requests_and_build_into_empty_in_slices_equal_reference(slices, monkeypatch):
    before = _force_slices(monkeypatch, _requests(12, 48, 400)[0], slices)
    _insert_and_into_empty_equal_reference()
    _slices_since(before, slices, stagings=2)


def test_concat_requests_and_empty_pool():
    a = pools.Requests(
        _t(np.array([1, -1], np.int32)),
        _t(np.array([2, 3], np.int32)),
        _t(np.array([0.5, 0.25], np.float32)),
    )
    cat = pools.concat_requests(a, a)
    assert cat.dst.tolist() == [1, -1, 1, -1] and cat.dist.dtype == torch.float32
    ep = pools.empty_pool(5, 3)
    assert ep.n == 5 and ep.r == 3 and int(ep.degree().sum()) == 0
    assert bool(torch.isinf(ep.dists).all())


@pytest.mark.parametrize("seed,n,d,s,r", [(0, 60, 16, 6, 8), (1, 200, 128, 12, 24)])
def test_init_random_with_reference_draws(seed, n, d, s, r, monkeypatch):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    raw = jax.random.randint(key, (n, s), 0, n - 1, jnp.int32)  # as jpools.init_random draws
    want = _init_ref(key, jnp.asarray(x), s, r)
    monkeypatch.setattr(pools, "OWNER_BLOCK", 7)  # blocked owner distances
    got = pools.init_random(RecordedDraws(np.asarray(raw), {}), _t(x), s, r)
    wd = np.asarray(want.dists)
    np.testing.assert_allclose(got.dists.numpy(), wd, rtol=1e-5)
    gap = np.diff(np.where(np.isinf(wd), 1e30, wd), axis=1)
    near = np.zeros_like(wd, bool)
    near[:, 1:] |= gap <= 1e-5 * np.abs(wd[:, 1:])
    near[:, :-1] |= near[:, 1:]
    same = got.ids.numpy() == np.asarray(want.ids)
    assert (same | near).all()


def test_merge_into_equals_reference_exactly():
    ids, dists = _pool(21, 32, 8)
    ci, cd = _pool(22, 32, 12)
    got = pools.merge_into(pools.Pool(_t(ids), _t(dists)), _t(ci), _t(cd))
    want = _merge_ref(jpools.Pool(jnp.asarray(ids), jnp.asarray(dists)), ci, cd)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))
