"""repro_torch.core.corpus_shard against the port's own search and repro.

  * The shard arithmetic (`shard_bounds`, `shard_of`, `local_of`,
    `global_of`) equals the reference's and round-trips exactly, for fixed
    and (with hypothesis) arbitrary (N, S).
  * The corpus-sharded search is bitwise the port's replicated `search`
    (ids, dists and n_expanded) for S in {1, 2, 3, 4}: fp32 dense, hashed
    with a small table (collisions), int8 and bf16 with the fp32 rescore,
    filtered, with tombstones, through `shard_optimized`, and with the
    host rescore tier. The combines are single-owner min / max, so no sum
    is re-associated.
  * Against `repro.core.corpus_shard.sharded_search` on the reference's
    sharded index carried across by `convert.corpus_sharded_from_jax`: ids
    equal in at least 90% of queries and distances within rtol 1e-5 where
    they are (fp32 sums in another order can flip a near-tie).
  * `memory_report` of the port's `shard()` equals the reference's dict.
  * `sharded_build`: S = 1 is exactly `build_graph` with the same draws; at
    S = 2 and 4 the pool is sorted, self-free and duplicate-free with edges
    across the boundaries; with the reference's draws recorded
    (`sharded_draws`), the cross candidates are the reference's exactly and
    recall@10 is within 0.02 of JAX's `sharded_build`, scored by the same
    reference search and ground truth.
  * `DynamicIndex.corpus_search` is bitwise `search` in label space after an
    insert, after deletes and after `compact()`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import optional_hypothesis
from repro.core import corpus_shard as JCS
from repro.core import grnnd as jgrnnd
from repro.core import labels as JL
from repro.core import recall as jrecall
from repro.core import vecstore as JVS
from repro.core.search import search as jsearch
from repro.data import synthetic as jsynthetic
from repro_torch import convert
from repro_torch.core import (
    DynamicConfig,
    DynamicIndex,
    Draws,
    GRNNDConfig,
    HostTier,
    RecordedDraws,
    build_graph,
    encode,
    encode_labels,
    optimize,
    search,
)
from repro_torch.core import corpus_shard as CS
from test_torch_grnnd import jax_draws

# the suite runs in parallel workers: one intra-op thread each keeps torch
# from oversubscribing the cores the JAX tests share
torch.set_num_threads(1)

given, settings, st = optional_hypothesis()

K, EF, N, NQ = 10, 32, 260, 12
SHARDS = (1, 2, 3, 4)
CFG = GRNNDConfig(s=8, r=16, t1=2, t2=3, pairs_per_vertex=16)
QUERY_MATCH = 0.9  # queries whose ids equal the reference's
RECALL_GAP = 0.02


def _jcfg(cfg):
    return jgrnnd.GRNNDConfig(**cfg._asdict())


@pytest.fixture(scope="module")
def case():
    """numpy data, queries, the reference's graph, labels and predicates."""
    x = np.array(jsynthetic.make_preset(jax.random.PRNGKey(0), "tiny", N))
    q = np.array(jsynthetic.queries_from(jax.random.PRNGKey(1), jnp.asarray(x), NQ))
    pool = jgrnnd.build_graph(jax.random.PRNGKey(2), jnp.asarray(x), _jcfg(CFG))
    rng = np.random.default_rng(3)
    vlabels = rng.integers(0, 20, N).astype(np.int32)
    fwords = np.asarray(JL.pack_ids(jnp.asarray(rng.integers(0, 20, NQ), jnp.int32), 20))
    valid = rng.random(N) > 0.15
    return dict(
        x=x, q=q, ids=np.array(pool.ids), dists=np.array(pool.dists),
        vlabels=vlabels, fwords=fwords, valid=valid,
    )


def _same(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


# ---------------------------------------------------------------------------
# the shard arithmetic
# ---------------------------------------------------------------------------


def _assert_id_map_laws(n: int, s: int) -> None:
    row0s, n_loc = CS.shard_bounds(n, s)
    assert (row0s, n_loc) == JCS.shard_bounds(n, s)
    assert n_loc == -(-n // s) and len(row0s) == s
    g = torch.arange(n, dtype=torch.int64)
    sh, loc = CS.shard_of(g, n_loc), CS.local_of(g, n_loc)
    assert int(sh.min()) >= 0 and int(sh.max()) < s
    assert int(loc.min()) >= 0 and int(loc.max()) < n_loc
    assert torch.equal(CS.global_of(sh, loc, n_loc), g)
    for i, row0 in enumerate(row0s):
        n_own = min(n_loc, n - row0)
        assert torch.equal(sh == i, (g >= row0) & (g < row0 + n_own))
        owned, local = CS._owner(g.int(), row0, n_own, n_loc)
        assert torch.equal(owned, sh == i)
        assert torch.equal(local[owned], loc[owned])


@pytest.mark.parametrize("n,s", [(1, 1), (7, 2), (260, 4), (100, 3), (64, 64), (5, 8)])
def test_id_map_round_trip(n, s):
    _assert_id_map_laws(n, s)


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 4096), st.integers(1, 16))
def test_id_map_round_trip_property(n, s):
    _assert_id_map_laws(n, s)


def test_stacked_slices_keep_every_row(case):
    x = torch.from_numpy(case["x"])
    row0s, n_loc = CS.shard_bounds(N, 3)
    stacked = CS._stack_shards(x, row0s, n_loc, 0)
    assert stacked.shape == (3, n_loc, x.shape[1])
    assert torch.equal(stacked.reshape(-1, x.shape[1])[:N], x)
    assert not stacked.reshape(-1, x.shape[1])[N:].any()  # the padded tail


# ---------------------------------------------------------------------------
# sharded == replicated, bitwise
# ---------------------------------------------------------------------------

MODES = ("fp32", "hashed", "int8", "bf16", "filtered", "tombstones", "optimized", "host")


def _operands(case, mode):
    """(search kwargs of the replicated search, shard kwargs, search kwargs
    of the sharded search) of one mode."""
    x = torch.from_numpy(case["x"])
    labels = encode_labels(case["vlabels"], 20)
    fw = torch.from_numpy(case["fwords"])
    valid = torch.from_numpy(case["valid"])
    if mode == "fp32":
        return dict(x=x), {}, {}
    if mode == "hashed":
        kw = dict(visited="hashed", visited_cap=64)
        return dict(x=x, **kw), {}, kw
    if mode in ("int8", "bf16"):
        st_ = encode(x, mode)
        return dict(x=st_, rescore=x), dict(rescore=x), {}
    if mode == "filtered":
        return dict(x=x, labels=labels, filter=fw), dict(labels=labels), dict(filter=fw)
    if mode == "tombstones":
        st_ = encode(x, "int8")
        kw = dict(visited="hashed", visited_cap=128)
        return dict(x=st_, valid=valid, rescore=x, **kw), dict(valid=valid, rescore=x), kw
    if mode == "host":
        st_ = encode(x, "int8")
        return dict(x=st_, rescore=HostTier(x), labels=labels, filter=fw), dict(
            rescore=x, labels=labels, tier="host"
        ), dict(filter=fw)
    raise ValueError(mode)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_search_bitwise_equal(case, mode, n_shards):
    q = torch.from_numpy(case["q"])
    if mode == "optimized":
        x = torch.from_numpy(case["x"])
        opt = optimize(
            encode(x, "int8"), torch.from_numpy(case["ids"]), order="bfs", rescore=x,
            valid=torch.from_numpy(case["valid"]), labels=encode_labels(case["vlabels"], 20),
            device="cpu",
        )
        fw = torch.from_numpy(case["fwords"])
        want = opt.search(q, k=K, ef=EF, filter=fw)
        idx = CS.shard_optimized(opt, n_shards)
        got = idx.search(q, k=K, ef=EF, filter=fw)
    else:
        rep_kw, shard_kw, search_kw = _operands(case, mode)
        x = rep_kw.pop("x")
        ids = torch.from_numpy(case["ids"])
        want = search(x, ids, q, k=K, ef=EF, device="cpu", **rep_kw)
        idx = CS.shard(x, ids, n_shards, device="cpu", **shard_kw)
        got = CS.sharded_search(idx, q, k=K, ef=EF, **search_kw)
    assert idx.n_shards == n_shards and idx.n == N
    assert _same(got, want), mode
    assert bool((got.ids[:, 0] >= 0).all())


# ---------------------------------------------------------------------------
# against the reference, on its own sharded index
# ---------------------------------------------------------------------------


def _jax_index(case, mode, n_shards):
    jx = jnp.asarray(case["x"])
    jids = jnp.asarray(case["ids"])
    jlabels = JL.encode_labels(jnp.asarray(case["vlabels"]), 20)
    if mode == "fp32":
        return JCS.shard(jx, jids, n_shards), {}
    if mode == "int8":
        return JCS.shard(JVS.encode(jx, "int8"), jids, n_shards, rescore=jx,
                         valid=jnp.asarray(case["valid"])), {}
    if mode == "filtered":
        return JCS.shard(jx, jids, n_shards, labels=jlabels), dict(filter=case["fwords"])
    if mode == "host":
        return JCS.shard(JVS.encode(jx, "int8"), jids, n_shards, rescore=jx, labels=jlabels,
                         tier="host"), dict(filter=case["fwords"])
    raise ValueError(mode)


@pytest.mark.parametrize("n_shards", (2, 4))
@pytest.mark.parametrize("mode", ("fp32", "int8", "filtered", "host"))
def test_sharded_search_matches_the_reference(case, mode, n_shards):
    jidx, kw = _jax_index(case, mode, n_shards)
    want = JCS.sharded_search(jidx, jnp.asarray(case["q"]), k=K, ef=EF,
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    idx = convert.corpus_sharded_from_jax(jidx, device="cpu")
    assert isinstance(idx.rescores, HostTier) == (mode == "host")
    got = CS.sharded_search(idx, case["q"], k=K, ef=EF, **kw)
    w_ids = np.asarray(want.ids)
    same = (got.ids.numpy() == w_ids).all(1)
    assert same.mean() >= QUERY_MATCH, same.mean()
    np.testing.assert_allclose(got.dists.numpy()[same], np.asarray(want.dists)[same], rtol=1e-5)


@pytest.mark.parametrize("n_shards", (2, 3))
@pytest.mark.parametrize("mode", ("fp32", "int8", "filtered", "host"))
def test_memory_report_equals_the_reference(case, mode, n_shards):
    jidx, _ = _jax_index(case, mode, n_shards)
    x = torch.from_numpy(case["x"])
    labels = encode_labels(case["vlabels"], 20)
    kw = {
        "fp32": dict(x=x),
        "int8": dict(x=encode(x, "int8"), rescore=x, valid=torch.from_numpy(case["valid"])),
        "filtered": dict(x=x, labels=labels),
        "host": dict(x=encode(x, "int8"), rescore=x, labels=labels, tier="host"),
    }[mode]
    idx = CS.shard(kw.pop("x"), case["ids"], n_shards, device="cpu", **kw)
    assert CS.memory_report(idx) == JCS.memory_report(jidx)
    assert CS.memory_report(convert.corpus_sharded_from_jax(jidx, device="cpu")) == (
        JCS.memory_report(jidx)
    )


# ---------------------------------------------------------------------------
# the sharded build
# ---------------------------------------------------------------------------


def sharded_draws(key, n: int, cfg, n_shards: int, merge_rounds: int, cross: int) -> RecordedDraws:
    """The draws `repro.core.corpus_shard.sharded_build(key, x, cfg,
    n_shards, merge_rounds=, cross_candidates=)` makes, recorded: each
    partition's build (`fold_in(key, s)`), each merge round's raw cross
    candidates (`fold_in(kt, 0)`) and localized slot pairs (`fold_in(kt, 1)`)."""
    row0s, n_loc = JCS.shard_bounds(n, n_shards)
    parts = {
        s: jax_draws(jax.random.fold_in(key, s), min(n_loc, n - row0), cfg)
        for s, row0 in enumerate(row0s)
    }
    raw, merge = {}, {}
    for t in range(merge_rounds):
        kt = jax.random.fold_in(jax.random.fold_in(key, 7919), t)
        raw[t] = np.asarray(
            jax.random.randint(jax.random.fold_in(kt, 0), (n, cross), 0, 2**31 - 1, jnp.int32)
        )
        merge[t] = tuple(
            np.asarray(a)
            for a in jgrnnd._sample_slot_pairs(jax.random.fold_in(kt, 1), n, cfg.r,
                                               cfg.pairs_per_vertex)
        )
    return RecordedDraws(partitions=parts, cross=raw, merge=merge)


def _pool_invariants(ids: np.ndarray, dists: np.ndarray, n_shards: int) -> None:
    n = ids.shape[0]
    assert ids.max() < n and ids.min() >= -1
    assert (np.diff(np.where(ids >= 0, dists, 1e30), axis=1) >= 0).all()
    assert not (ids == np.arange(n)[:, None]).any()
    n_loc = CS.shard_bounds(n, n_shards)[1]
    crossing = 0
    for v, row in enumerate(ids):
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live), v
        crossing += int((live // n_loc != v // n_loc).any())
    assert crossing > n // 4, crossing  # the boundaries were stitched


def test_sharded_build_single_shard_is_build_graph(case):
    draws = Draws(5, "cpu")
    one = CS.sharded_build(case["x"], CFG, 1, draws=draws, device="cpu")
    want = build_graph(case["x"], CFG, draws=draws, device="cpu")
    assert torch.equal(one.ids, want.ids) and torch.equal(one.dists, want.dists)


@pytest.mark.parametrize("n_shards", (2, 4))
def test_sharded_build_pool_invariants(case, n_shards):
    pool = CS.sharded_build(case["x"], CFG, n_shards, merge_rounds=2, device="cpu")
    assert pool.ids.shape == (N, CFG.r)
    _pool_invariants(pool.ids.numpy(), pool.dists.numpy(), n_shards)
    idx = CS.shard(case["x"], pool, n_shards, device="cpu")
    res = idx.search(case["q"], k=K, ef=EF)
    assert bool((res.ids[:, 0] >= 0).all())


def test_cross_candidates_are_the_reference_s():
    n, s, c = 1003, 4, 8
    key = jax.random.PRNGKey(9)
    row0s, n_loc = JCS.shard_bounds(n, s)
    want = JCS._cross_candidates(key, n, row0s, n_loc, c)
    raw = jax.random.randint(key, (n, c), 0, 2**31 - 1, jnp.int32)
    got = CS._cross_candidates(torch.from_numpy(np.asarray(raw)), n, n_loc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() // n_loc != (np.arange(n) // n_loc)[:, None]).all()


@pytest.mark.parametrize("n_shards", (2, 4))
def test_sharded_build_recall_matches_reference(n_shards):
    n, merge_rounds, cross = 1200, 3, 8
    cfg = GRNNDConfig(s=8, r=16, t1=3, t2=3, pairs_per_vertex=16)
    x = np.array(jsynthetic.make_preset(jax.random.PRNGKey(0), "sift-like", n))
    jx = jnp.asarray(x)
    queries = jsynthetic.queries_from(jax.random.PRNGKey(1), jx, 128)
    truth = jrecall.brute_force_knn(jx, queries, K)
    key = jax.random.PRNGKey(2)
    want = JCS.sharded_build(key, jx, _jcfg(cfg), n_shards, merge_rounds=merge_rounds,
                             cross_candidates=cross)
    draws = sharded_draws(key, n, cfg, n_shards, merge_rounds, cross)
    got = CS.sharded_build(x, cfg, n_shards, merge_rounds=merge_rounds,
                           cross_candidates=cross, draws=draws, device="cpu")
    _pool_invariants(got.ids.numpy(), got.dists.numpy(), n_shards)

    def recall(ids):
        res = jsearch(jx, jnp.asarray(ids), queries, k=K, ef=48)
        return jrecall.recall_at_k(res.ids, truth)

    r_want, r_got = recall(np.asarray(want.ids)), recall(got.ids.numpy())
    assert abs(r_got - r_want) <= RECALL_GAP, (r_got, r_want)
    assert r_got > 0.8


# ---------------------------------------------------------------------------
# the dynamic index, sharded per call
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("mode", ("fp32", "int8-host-labeled"))
def test_dynamic_corpus_search_is_search_in_label_space(n_shards, mode):
    x = np.array(jsynthetic.make_preset(jax.random.PRNGKey(0), "tiny", 300))
    q = np.array(jsynthetic.queries_from(jax.random.PRNGKey(1), jnp.asarray(x), 16))
    pool = build_graph(x[:240], CFG, draws=Draws(2, "cpu"), device="cpu")
    labeled = mode != "fp32"
    dc = DynamicConfig(refine_rounds=1, compact_threshold=0.9)
    kw, vl = {}, None
    if labeled:
        dc = dc._replace(precision="int8", tier="host")
        vl = np.arange(300, dtype=np.int32) % 7
        kw = dict(vertex_labels=vl[:240], n_labels=7)
    idx = DynamicIndex(x[:240], pool, dc, draws=Draws(3, "cpu"), device="cpu", **kw)
    skw = dict(k=K, ef=EF)
    if labeled:
        skw.update(visited="hashed", visited_cap=64, filter=np.arange(16, dtype=np.int32) % 7)

    def check(stage):
        assert _same(idx.corpus_search(q, n_shards, **skw), idx.search(q, **skw)), stage

    idx.insert(x[240:], **({"vertex_labels": vl[240:]} if labeled else {}))
    check("insert")
    dead = np.arange(0, 240, 5)
    idx.delete(dead)
    check("delete")
    got = idx.corpus_search(q, n_shards, **skw).ids.numpy()
    assert not set(got[got >= 0].tolist()) & set(dead.tolist())
    idx.compact()
    check("compact")
