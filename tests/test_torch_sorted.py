"""The sorted-order ablation (paper Alg. 2, Fig. 7) against repro.core.grnnd.

The sorted round draws nothing, so on the same pool and data both sides
evaluate the same candidates in the same order; what may differ is fp32
rounding of the (C, R, R) Gram (a product summed in another order, max
rel. error ~4e-7), which can flip a conflict test d(n, n') <= d(v, n) at a
near-tie. Hence:

  * one sorted round's redirect requests and kill mask equal the
    reference's in every row without such a near-tie (a float64 Gram entry
    d(n, n') within 1e-4 (|n|^2 + |n'|^2) of a candidate's distance), and
    in at least 99% of rows; redirect distances within 1e-5 (|n|^2 + |n'|^2),
    the cancellation bound of the norm-decomposed Gram (B5's tolerance);
  * the round blocked over rows equals the one-shot round exactly (rows
    are independent and nothing is drawn);
  * with the reference's init draws, ascending and descending builds reach
    a recall@10 within 0.02 of `repro.core.build_graph`, scored by the same
    reference search and ground truth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grnnd as jgrnnd
from repro.core import pools as jpools
from repro.core import recall as jrecall
from repro.core.search import medoid as jmedoid
from repro.core.search import search as jsearch
from repro.data import synthetic as jsynthetic
from repro_torch.core import encode, grnnd, pools
from test_torch_grnnd import jax_draws

# the suite runs in parallel workers: one intra-op thread each keeps torch
# from oversubscribing the cores the JAX tests share
torch.set_num_threads(1)

ORDERS = ("ascending", "descending")
ROW_MATCH = 0.99
RECALL_GAP = 0.02
GRAM_REL = 1e-5


def _data(preset, n, seed=0):
    return np.array(jsynthetic.make_preset(jax.random.PRNGKey(seed), preset, n))


def _one_round_pool(x, cfg):
    """A pool as a build holds it after its init and one disordered round."""
    jx = jnp.asarray(x)
    pool = jpools.init_random(jax.random.PRNGKey(1), jx, cfg.s, cfg.r)
    jcfg = jgrnnd.GRNNDConfig(**cfg._replace(order="disordered")._asdict())
    return jax.jit(jgrnnd.update_round, static_argnums=(3,))(jx, pool, jax.random.PRNGKey(2), jcfg)


def _near_tie_rows(x, ids, dists) -> np.ndarray:
    """Rows where some pair's float64 Gram entry d(n, n') sits within
    1e-4 (|n|^2 + |n'|^2) of a candidate's distance d(v, n)."""
    vec = x.astype(np.float64)[np.clip(ids, 0, None)]  # (C, R, D)
    gram = ((vec[:, :, None, :] - vec[:, None, :, :]) ** 2).sum(-1)  # (C, R, R)
    sq = (vec * vec).sum(-1)
    dv = np.where(ids >= 0, dists, np.inf).astype(np.float64)
    near = np.abs(gram - dv[:, :, None]) <= 1e-4 * (sq[:, :, None] + sq[:, None, :])
    live = (ids[:, :, None] >= 0) & (ids[:, None, :] >= 0)
    return (near & live).any((1, 2))


@pytest.mark.parametrize("order", ORDERS)
def test_sorted_requests_and_kill_mask_match_the_reference(order):
    n = 600
    x = _data("sift-like", n)
    cfg = grnnd.GRNNDConfig(s=8, r=16, t1=1, t2=1, pairs_per_vertex=16, order=order)
    jpool = _one_round_pool(x, cfg)
    jcfg = jgrnnd.GRNNDConfig(**cfg._asdict())
    want_red, want_kill = jax.jit(jgrnnd._sorted_requests_chunk, static_argnums=(5,))(
        jnp.asarray(x), jpool.ids, jpool.dists, None, None, jcfg
    )
    ids, dists = np.asarray(jpool.ids), np.asarray(jpool.dists)
    red, kill = grnnd._sorted_requests_chunk(
        torch.from_numpy(x), torch.from_numpy(ids.copy()), torch.from_numpy(dists.copy()), cfg
    )
    r = cfg.r
    dst, wdst = red.dst.numpy().reshape(n, r), np.asarray(want_red.dst).reshape(n, r)
    np.testing.assert_array_equal(red.src.numpy(), np.asarray(want_red.src))
    rows_eq = (dst == wdst).all(1) & (kill.numpy() == np.asarray(want_kill)).all(1)
    assert rows_eq.mean() >= ROW_MATCH, rows_eq.mean()
    assert not (~rows_eq & ~_near_tie_rows(x, ids, dists)).any()
    live = (dst >= 0) & rows_eq[:, None]
    sq = (x * x).sum(-1)
    scale = sq[dst.clip(0)] + sq[red.src.numpy().reshape(n, r).clip(0)]
    err = np.abs(red.dist.numpy().reshape(n, r) - np.asarray(want_red.dist).reshape(n, r))
    assert (err[live] <= GRAM_REL * scale[live]).all()
    assert live.any() and kill.numpy().any()  # the round redirects and kills


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("store", ["fp32", "int8"])
def test_blocked_and_one_shot_sorted_rounds_are_equal(order, store):
    n = 500
    x = torch.from_numpy(_data("deep-like", n))
    cfg = grnnd.GRNNDConfig(s=8, r=16, t1=1, t2=1, pairs_per_vertex=16, order=order)
    pool = _one_round_pool(x.numpy(), cfg)
    ids, dists = torch.tensor(np.asarray(pool.ids)), torch.tensor(np.asarray(pool.dists))
    data = x if store == "fp32" else encode(x, store)
    one = grnnd._sorted_requests_chunk(data, ids, dists, cfg, block=None)
    for block in (1, 37, 499):
        got = grnnd._sorted_requests_chunk(data, ids, dists, cfg, block=block)
        assert all(torch.equal(a, b) for a, b in zip(got[0], one[0]))
        assert torch.equal(got[1], one[1])
    # a whole round through update_round: the pool stays sorted and unique
    out = grnnd.update_round(data, pools.Pool(ids, dists), None, cfg)
    o_ids, o_d = out.ids.numpy(), out.dists.numpy()
    assert (np.diff(np.where(o_ids >= 0, o_d, 1e30), axis=1) >= 0).all()
    assert not (o_ids == np.arange(n)[:, None]).any()


@pytest.mark.parametrize("order", ORDERS)
def test_sorted_build_recall_matches_reference(order):
    n = 1500
    cfg = grnnd.GRNNDConfig(s=8, r=16, t1=3, t2=3, pairs_per_vertex=16, order=order)
    x = _data("sift-like", n)
    jx = jnp.asarray(x)
    queries = jsynthetic.queries_from(jax.random.PRNGKey(1), jx, 100)
    truth = jrecall.brute_force_knn(jx, queries, 10)
    key = jax.random.PRNGKey(4)
    want = jgrnnd.build_graph(key, jx, jgrnnd.GRNNDConfig(**cfg._asdict()))
    got = grnnd.build_graph(x, cfg, draws=jax_draws(key, n, cfg), device="cpu")
    entry = jmedoid(jx)

    def recall(ids):
        res = jsearch(jx, jnp.asarray(ids), queries, k=10, ef=32, entry=entry)
        return jrecall.recall_at_k(res.ids, truth)

    r_want, r_got = recall(np.asarray(want.ids)), recall(got.ids.numpy())
    assert abs(r_got - r_want) <= RECALL_GAP, (r_got, r_want)
    assert r_got > 0.5


def test_unknown_order_raises():
    cfg = grnnd.GRNNDConfig(s=4, r=8, t1=1, t2=1, pairs_per_vertex=8, order="shuffled")
    with pytest.raises(ValueError, match="order must be one of"):
        grnnd.build_graph(np.zeros((20, 4), np.float32), cfg, device="cpu")
