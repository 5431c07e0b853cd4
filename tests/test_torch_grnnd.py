"""repro_torch.core.grnnd against repro.core.grnnd with the reference's draws.

`jax_draws` replays the reference's key schedule (init ids from the first
half of the build key; per round fold_in(fold_in(k_rounds, t1), t2), split
per chunk when the round is chunked) into a `RecordedDraws`, so both builds
evaluate the same random pairs. What may still differ is fp32 rounding:
distances are summed in another order (max rel. error ~4e-7), which can flip
an RNG hit test or a merge order at a near-tie.

  * one round: pool ids equal the reference's except in rows touched by a
    near-tie (at least 99% of rows equal);
  * reverse-edge rounds are integer work on an identical pool: exact;
  * a whole build: recall@10 within 0.02 of the reference build on
    sift-like, deep-like and gist-like data (the graphs drift apart round by
    round from the first near-tie on, so they are compared by the recall
    they reach, scored by the same reference search and ground truth).
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
from repro_torch.core import grnnd, pools
from repro_torch.core.draws import Draws, RecordedDraws

# the suite runs in parallel workers: one intra-op thread each keeps torch
# from oversubscribing the cores the JAX tests share
torch.set_num_threads(1)


def jax_draws(key, n: int, cfg) -> RecordedDraws:
    """The draws `repro.core.grnnd.build_graph(key, x, cfg)` makes, recorded."""
    k_init, k_rounds = jax.random.split(key)
    init = jax.random.randint(k_init, (n, cfg.s), 0, n - 1, jnp.int32)
    chunk = cfg.chunk_size
    chunked = chunk is not None and n % chunk == 0 and chunk < n
    pairs = {}
    for t1 in range(cfg.t1):
        for t2 in range(cfg.t2):
            k = jax.random.fold_in(jax.random.fold_in(k_rounds, t1), t2)
            if not chunked:
                si, sj = jgrnnd._sample_slot_pairs(k, n, cfg.r, cfg.pairs_per_vertex)
                pairs[(t1, t2, None)] = (si, sj)
                continue
            for i, kc in enumerate(jax.random.split(k, n // chunk)):
                si, sj = jgrnnd._sample_slot_pairs(kc, chunk, cfg.r, cfg.pairs_per_vertex)
                pairs[(t1, t2, i)] = (si, sj)
    return RecordedDraws(np.asarray(init), {k: tuple(map(np.asarray, v)) for k, v in pairs.items()})


def _jcfg(cfg):
    """The reference's GRNNDConfig with the same fields."""
    return jgrnnd.GRNNDConfig(**cfg._asdict())


def _data(preset, n, seed=0):
    return np.asarray(jsynthetic.make_preset(jax.random.PRNGKey(seed), preset, n))


@pytest.mark.parametrize("chunk_size", [None, 100])
def test_one_update_round_matches_reference(chunk_size):
    n = 400
    cfg = grnnd.GRNNDConfig(s=8, r=16, t1=1, t2=1, pairs_per_vertex=16, chunk_size=chunk_size)
    x = _data("sift-like", n)
    key = jax.random.PRNGKey(3)
    draws = jax_draws(key, n, cfg)
    k_init, k_rounds = jax.random.split(key)
    jpool = jax.jit(jpools.init_random, static_argnums=(2, 3))(k_init, x, cfg.s, cfg.r)
    k = jax.random.fold_in(jax.random.fold_in(k_rounds, 0), 0)
    want = jax.jit(jgrnnd.update_round, static_argnums=(3,))(x, jpool, k, _jcfg(cfg))

    pool = pools.Pool(torch.tensor(np.asarray(jpool.ids)), torch.tensor(np.asarray(jpool.dists)))
    got = grnnd.update_round(torch.from_numpy(x), pool, draws, cfg, 0, 0)
    same_rows = (got.ids.numpy() == np.asarray(want.ids)).all(1)
    assert same_rows.mean() >= 0.99, same_rows.mean()
    np.testing.assert_allclose(
        got.dists.numpy()[same_rows], np.asarray(want.dists)[same_rows], rtol=1e-5
    )


def test_reverse_edge_round_is_exact_on_an_identical_pool():
    """Integer work: the fp32 ceil(rho * degree) prefix and the staging."""
    n, r = 300, 10
    rng = np.random.default_rng(5)
    ids = rng.integers(0, n, (n, r)).astype(np.int32)
    ids[rng.random((n, r)) < 0.4] = -1
    dists = np.sort(rng.random((n, r)).astype(np.float32), axis=1)
    order = np.argsort(ids < 0, axis=1, kind="stable")  # live slots first
    ids = np.take_along_axis(ids, order, 1)
    dists[ids < 0] = np.inf
    cfg = grnnd.GRNNDConfig(r=r, rho=0.6)
    want = jax.jit(jgrnnd.reverse_edge_round, static_argnums=(1,))(
        jpools.Pool(jnp.asarray(ids), jnp.asarray(dists)), _jcfg(cfg)
    )
    got = grnnd.reverse_edge_round(pools.Pool(torch.from_numpy(ids), torch.from_numpy(dists)), cfg)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))


@pytest.mark.parametrize("preset,n", [("sift-like", 1500), ("deep-like", 1500), ("gist-like", 600)])
def test_build_recall_matches_reference(preset, n):
    cfg = grnnd.GRNNDConfig(s=8, r=16, t1=3, t2=3, pairs_per_vertex=16)
    x = _data(preset, n)
    queries = np.asarray(jsynthetic.queries_from(jax.random.PRNGKey(1), jnp.asarray(x), 100))
    truth = jrecall.brute_force_knn(jnp.asarray(x), jnp.asarray(queries), 10)
    key = jax.random.PRNGKey(2)
    want = jgrnnd.build_graph(key, jnp.asarray(x), _jcfg(cfg))
    got = grnnd.build_graph(x, cfg, draws=jax_draws(key, n, cfg), device="cpu")
    entry = jmedoid(jnp.asarray(x))

    def recall(ids):
        xq = jnp.asarray(queries)
        res = jsearch(jnp.asarray(x), jnp.asarray(ids), xq, k=10, ef=32, entry=entry)
        return jrecall.recall_at_k(res.ids, truth)

    r_want, r_got = recall(np.asarray(want.ids)), recall(got.ids.numpy())
    assert abs(r_got - r_want) <= 0.02, (r_got, r_want)
    assert r_got > 0.5


def test_build_graph_with_stats_and_stateless_draws():
    cfg = grnnd.GRNNDConfig(s=6, r=12, t1=2, t2=2, pairs_per_vertex=12)
    x = _data("tiny", 300)
    draws = Draws(7, "cpu")
    pool, stats = grnnd.build_graph_with_stats(x, cfg, draws=draws, device="cpu")
    again = grnnd.build_graph(x, cfg, draws=draws, device="cpu")
    assert torch.equal(pool.ids, again.ids) and torch.equal(pool.dists, again.dists)
    assert [(s["t1"], s["t2"]) for s in stats] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(0 < s["mean_degree"] <= cfg.r for s in stats)
    assert pool.ids.dtype == torch.int32 and pool.dists.dtype == torch.float32
    # pools stay distance-sorted, self-free and duplicate-free
    ids, d = pool.ids.numpy(), pool.dists.numpy()
    assert (np.diff(np.where(ids >= 0, d, 1e30), axis=1) >= 0).all()
    assert not (ids == np.arange(len(ids))[:, None]).any()
    for row in ids:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)


def test_build_graph_without_a_card_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = grnnd.GRNNDConfig(s=4, r=8, t1=1, t2=1, pairs_per_vertex=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grnnd.build_graph(_data("tiny", 50), cfg)
