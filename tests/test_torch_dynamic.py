"""repro_torch's dynamic index, search options and int8 build against repro.

The reference's draws are injected (`localized_draws` replays the key chain
a JAX `DynamicIndex` splits once per localized round), so both sides
evaluate the same random slot pairs; what may still differ is fp32 summation
order (max rel. error ~4e-7), which can flip an RNG hit test, a merge order
or a beam choice at a near-tie. Hence:

  * pools after construction (the int8 re-base through `gather_sqdist`)
    and after an insert batch: at least 99% of rows equal, distances to
    rtol 1e-5 where they are;
  * searches with `valid` and `rescore` over an int8 store, and the
    dynamic index's searches: at least 97% of queries return identical
    ids, and recall@10 within 0.01 of the reference;
  * compaction of an identical state is integer work on identical inputs:
    pools, labels and the cached entry equal exactly, and the port's own
    search returns identical ids and distances before and after it;
  * the static int8 build (the reference's draws): recall@10 within 0.02
    of the reference build, scored by the same search.

The fixture is tests/test_dynamic.py's: sift-like, n = 1,200, a 90% base
build and a 10% insert.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grnnd as jgrnnd
from repro.core import labels as JL
from repro.core import recall as jrecall
from repro.core import vecstore as jvs
from repro.core.dynamic import DynamicConfig as JDynamicConfig
from repro.core.dynamic import DynamicIndex as JDynamicIndex
from repro.core.pools import Pool as JPool
from repro.core.search import medoid as jmedoid
from repro.core.search import search as jsearch
from repro_torch import convert
from repro_torch.core import (
    DynamicConfig,
    DynamicIndex,
    GRNNDConfig,
    Pool,
    brute_force_knn,
    build_graph,
    recall_at_k,
    search,
)
from repro_torch.core.draws import Draws, RecordedDraws
from repro_torch.core.labels import filtered_recall_at_k, pack_ids, predicate_fraction
from repro_torch.core.search import medoid
from repro_torch.data import synthetic
from test_torch_grnnd import jax_draws

# the suite runs in parallel workers: one intra-op thread each keeps torch
# from oversubscribing the cores the JAX tests share
torch.set_num_threads(1)

K, EF = 10, 48
N, N_BASE = 1200, 1080
CFG = jgrnnd.GRNNDConfig(s=8, r=16, t1=3, t2=3, pairs_per_vertex=16)
ROW_MATCH = 0.99  # pool rows equal to the reference's (near-ties aside)
QUERY_MATCH = 0.97  # queries whose ids equal the reference's
RECALL_GAP = 0.01


def localized_draws(key, frontiers, r: int, p: int) -> RecordedDraws:
    """The slot pairs of the localized rounds a JAX `DynamicIndex` holding
    `key` draws next, one round per frontier size."""
    loc = {}
    for i, f in enumerate(frontiers):
        key, k = jax.random.split(key)
        loc[i] = tuple(np.asarray(a) for a in jgrnnd._sample_slot_pairs(k, f, r, p))
    return RecordedDraws(localized=loc)


def _dcfg(precision="fp32", **kw) -> DynamicConfig:
    base = dict(seed_k=8, seed_ef=EF, refine_rounds=2, pairs_per_vertex=16, precision=precision)
    return DynamicConfig(**{**base, **kw})


def _jdcfg(cfg: DynamicConfig) -> JDynamicConfig:
    return JDynamicConfig(**cfg._asdict())


def _port_copy(jidx, cfg: DynamicConfig, draws=None) -> DynamicIndex:
    """The reference index's state carried into the port (on the CPU)."""
    store = None
    if jidx.store is not None:
        store = tuple(None if a is None else np.asarray(a) for a in jidx.store)
    return convert.dynamic_from_jax(
        x=np.asarray(jidx.x),
        store=store,
        pool_ids=np.asarray(jidx.pool.ids),
        pool_dists=np.asarray(jidx.pool.dists),
        valid=np.asarray(jidx.valid),
        labels=jidx.labels,
        size=jidx.size,
        n_live=jidx.n_live,
        next_label=jidx._next_label,
        entry=None if jidx._entry is None else np.asarray(jidx._entry),
        rounds_run=jidx.rounds_run,
        cfg=cfg,
        draws=draws,
        device="cpu",
    )


def _row_match(a, b) -> float:
    return float((np.asarray(a) == np.asarray(b)).all(1).mean())


def _query_match(a, b) -> float:
    return float((np.asarray(a) == np.asarray(b)).all(1).mean())


@pytest.fixture(scope="module")
def corpus():
    """sift-like rows and queries from a seed, handed to both packages."""
    g = torch.Generator().manual_seed(0)
    x = synthetic.make_preset(g, "sift-like", N)
    q = synthetic.queries_from(g, x, 128)
    gt = brute_force_knn(x, q, K, device="cpu").numpy()
    return x.numpy(), q.numpy(), gt


@pytest.fixture(scope="module")
def base_pool(corpus):
    x = corpus[0]
    return jgrnnd.build_graph(jax.random.PRNGKey(2), jnp.asarray(x[:N_BASE]), CFG)


@pytest.fixture(scope="module", params=["fp32", "int8"])
def churned(request, corpus, base_pool):
    """Both indexes over the base build, then one insert of the last 10%."""
    x = corpus[0]
    cfg = _dcfg(request.param)
    jidx = JDynamicIndex(jnp.asarray(x[:N_BASE]), base_pool, _jdcfg(cfg))
    b = N - N_BASE
    draws = localized_draws(jidx._key, [b + b * cfg.seed_k] * cfg.refine_rounds, CFG.r, 16)
    pool = Pool(torch.tensor(np.asarray(base_pool.ids)), torch.tensor(np.asarray(base_pool.dists)))
    tidx = DynamicIndex(x[:N_BASE], pool, cfg, draws=draws, device="cpu")
    constructed = (
        np.asarray(jidx.pool.ids),
        np.asarray(jidx.pool.dists),
        tidx.pool.ids.numpy().copy(),
        tidx.pool.dists.numpy().copy(),
    )
    labels = (jidx.insert(jnp.asarray(x[N_BASE:])), tidx.insert(x[N_BASE:]))
    return cfg, jidx, tidx, constructed, labels


# ---------------------------------------------------------------------------
# insert: construction re-base, seed search, staging, localized rounds
# ---------------------------------------------------------------------------


def test_construction_rebases_the_pool_like_the_reference(churned):
    cfg, _, _, (j_ids, j_d, t_ids, t_d), _ = churned
    assert _row_match(t_ids, j_ids) >= ROW_MATCH
    same = (t_ids == j_ids).all(1)
    np.testing.assert_allclose(t_d[same], j_d[same], rtol=1e-5, atol=1e-5)
    if cfg.precision == "fp32":  # no re-base: the pool is carried as it is
        np.testing.assert_array_equal(t_d, j_d)


def test_insert_pools_match_the_reference(churned):
    _, jidx, tidx, _, (jlab, tlab) = churned
    assert tlab.tolist() == np.asarray(jlab).tolist() == list(range(N_BASE, N))
    assert (tidx.size, tidx.n_live, tidx.capacity) == (jidx.size, jidx.n_live, jidx.capacity)
    assert tidx.rounds_run == jidx.rounds_run == 2
    assert _row_match(tidx.pool.ids, jidx.pool.ids) >= ROW_MATCH
    assert torch.equal(tidx.labels, torch.from_numpy(jidx.labels))
    if tidx.store is not None:  # inserted rows quantized with the frozen params
        np.testing.assert_array_equal(tidx.store.data.numpy(), np.asarray(jidx.store.data))


def test_insert_recall_matches_the_reference(churned, corpus):
    _, jidx, tidx, _, _ = churned
    _, q, gt = corpus
    want = jidx.search(jnp.asarray(q), k=K, ef=EF)
    got = tidx.search(q, k=K, ef=EF)
    assert _query_match(got.ids, want.ids) >= QUERY_MATCH
    rec = recall_at_k(got.ids, gt)
    assert abs(rec - jrecall.recall_at_k(want.ids, gt)) <= RECALL_GAP and rec >= 0.9, rec


# ---------------------------------------------------------------------------
# delete, compaction, the entry cache
# ---------------------------------------------------------------------------


def test_delete_matches_the_reference_and_never_returns_deleted(churned, corpus):
    cfg, jidx, _, _, _ = churned
    _, q, _ = corpus
    jcopy, tcopy = copy.copy(jidx), _port_copy(jidx, cfg)
    dels = np.arange(0, N, 5)  # 20%, under the auto-compact threshold
    assert tcopy.delete(dels) == jcopy.delete(dels) == dels.size
    assert tcopy.delete(dels) == 0  # idempotent
    with pytest.raises(KeyError):
        tcopy.delete(np.array([N + 5]))
    assert torch.equal(tcopy.valid, torch.from_numpy(np.asarray(jcopy.valid)))
    got = tcopy.search(q, k=K, ef=EF)
    assert not np.isin(got.ids.numpy(), dels).any()
    assert _query_match(got.ids, jcopy.search(jnp.asarray(q), k=K, ef=EF).ids) >= QUERY_MATCH
    live_gt = tcopy.exact_knn(q, K)
    assert recall_at_k(live_gt, jcopy.exact_knn(jnp.asarray(q), K)) >= 0.995
    assert recall_at_k(got.ids, live_gt) >= 0.85


def test_compact_matches_the_reference_exactly(churned, corpus):
    cfg, jidx, _, _, _ = churned
    _, q, _ = corpus
    jcopy, tcopy = copy.copy(jidx), _port_copy(jidx, cfg)
    jcopy.entry()  # cache the entry on both
    tcopy._entry = torch.tensor(int(jcopy._entry), dtype=torch.int32)
    dels = np.sort(np.random.default_rng(5).choice(N, size=400, replace=False))
    jcopy.delete(dels)
    tcopy.delete(dels)  # 33% > 25%: both compact by themselves
    assert tcopy.size == jcopy.size == N - 400 and tcopy.capacity == jcopy.capacity
    assert torch.equal(tcopy.pool.ids, torch.from_numpy(np.asarray(jcopy.pool.ids)))
    assert torch.equal(tcopy.pool.dists, torch.from_numpy(np.asarray(jcopy.pool.dists)))
    assert torch.equal(tcopy.labels, torch.from_numpy(jcopy.labels))
    assert torch.equal(tcopy.x, torch.from_numpy(np.asarray(jcopy.x)))
    assert (tcopy._entry is None) == (jcopy._entry is None)
    if tcopy._entry is not None:
        assert int(tcopy._entry) == int(jcopy._entry)


@pytest.mark.parametrize("seed,frac", [(0, 0.1), (1, 0.2), (2, 0.6)])
def test_compact_preserves_search_exactly(churned, corpus, seed, frac):
    cfg, jidx, _, _, _ = churned
    _, q, _ = corpus
    idx = _port_copy(jidx, cfg._replace(compact_threshold=0.9))
    dels = np.random.default_rng(seed).choice(N, size=int(N * frac), replace=False)
    idx.delete(np.sort(dels))
    before = idx.search(q, k=K, ef=EF)
    hashed = idx.search(q, k=K, ef=EF, visited="hashed", visited_cap=4096)
    gt_before = idx.exact_knn(q, K)
    idx.compact()
    assert idx.size == idx.n_live == N - dels.size
    after = idx.search(q, k=K, ef=EF)
    assert torch.equal(before.ids, after.ids) and torch.equal(before.dists, after.dists)
    # a collision-free hashed table is the dense search
    assert torch.equal(hashed.ids, after.ids)
    assert torch.equal(gt_before, idx.exact_knn(q, K))


def test_delete_retry_after_compact_is_noop(churned):
    cfg, jidx, _, _, _ = churned
    idx = _port_copy(jidx, cfg)
    dels = np.arange(40)
    assert idx.delete(dels) == 40
    idx.compact()
    assert idx.delete(dels) == 0  # physically gone: still a no-op
    assert idx.delete(torch.arange(40)) == 0  # labels may come as a tensor
    with pytest.raises(KeyError):
        idx.delete(np.array([idx._next_label]))  # never issued


def test_entry_cache_survives_unrelated_deletes_only(churned, corpus):
    cfg, jidx, _, _, _ = churned
    _, q, _ = corpus
    idx = _port_copy(jidx, cfg._replace(compact_threshold=0.95))
    idx.search(q[:4], k=K, ef=EF)  # warm the entry cache
    e = int(idx._entry)
    # keep the entry and the 99 vertices farthest from it (92% tombstones,
    # under the 0.95 auto-compact threshold): the live medoid moves, so a
    # recomputed entry would differ from the cached one
    far = torch.argsort((idx.x[:N] - idx.x[e]).norm(dim=1))[-99:].tolist()
    dels = np.array(sorted(set(range(N)) - set(far) - {e}))
    live = torch.zeros(idx.capacity, dtype=torch.bool)
    live[far + [e]] = True
    assert int(medoid(idx._tier(), live)) != e, "the delete set must move the live medoid"
    idx.delete(dels)
    assert idx._entry is not None and int(idx._entry) == e
    got = idx.search(q, k=K, ef=EF)
    want = search(
        idx._tier(),
        idx.pool.ids,
        q,
        k=K,
        ef=EF,
        entry=torch.tensor(e, dtype=torch.int32),
        valid=idx.valid,
        rescore=idx.x if idx.store is not None else None,
        device="cpu",
    )
    assert torch.equal(got.ids, idx._to_labels(want.ids)) and torch.equal(got.dists, want.dists)
    # deleting the entry's own slot drops the cache; the next search reseeds
    idx.delete(np.array([int(idx.labels[e])]))
    assert idx._entry is None
    res = idx.search(q, k=K, ef=EF)
    assert int(idx._entry) != e and bool(idx.valid[int(idx._entry)])
    assert int(idx.labels[e]) not in set(res.ids.flatten().tolist())


def test_insert_into_emptied_index_rebootstraps_like_the_reference(corpus):
    """Delete everything, compact to size 0, insert again: the batch seeds
    off itself (in the int8 tier's distance space), as the reference does,
    and stays searchable. The first graph is deleted whole, so it starts
    empty."""
    x, _, _ = corpus
    cfg = DynamicConfig(refine_rounds=2, compact_threshold=0.5, seed_k=6, precision="int8")
    ids = np.full((100, 8), -1, np.int32)
    dists = np.full((100, 8), np.inf, np.float32)
    jidx = JDynamicIndex(jnp.asarray(x[:100]), JPool(ids, dists), _jdcfg(cfg))
    draws = localized_draws(jidx._key, [20 + 20 * 6] * 2, 8, cfg.pairs_per_vertex)
    tidx = DynamicIndex(x[:100], Pool(ids, dists), cfg, draws=draws, device="cpu")
    for idx in (jidx, tidx):
        idx.delete(np.arange(100))  # auto-compacts to size 0
        assert idx.size == 0 and idx.n_live == 0
    assert tidx.delete(np.arange(5)) == 0  # a fully-compacted index: no-op
    assert tidx.insert(x[100:120]).tolist() == list(range(100, 120))
    jidx.insert(jnp.asarray(x[100:120]))
    assert _row_match(tidx.pool.ids[:20], np.asarray(jidx.pool.ids[:20])) >= 0.95
    q = x[100:120] + 0.01
    res = tidx.search(q, k=5, ef=16)
    assert recall_at_k(res.ids, tidx.exact_knn(q, 5)) >= 0.8


def test_insert_grows_capacity_and_issues_monotone_labels(corpus):
    x = corpus[0]
    cfg = GRNNDConfig(s=6, r=8, t1=2, t2=2, pairs_per_vertex=8)
    pool = build_graph(x[:200], cfg, draws=Draws(1, "cpu"), device="cpu")
    idx = DynamicIndex(x[:200], pool, DynamicConfig(refine_rounds=1), device="cpu")
    assert idx.capacity == 256 and idx.device.type == "cpu"
    assert idx.insert(x[200:280]).tolist() == list(range(200, 280))
    assert idx.capacity == 512 and idx.n_live == len(idx) == 280
    assert idx.tombstone_fraction == 0.0
    assert int(idx.search(x[:4], k=5, ef=16).ids.max()) < 280
    with pytest.raises(ValueError):
        idx.insert(x[:0])


# ---------------------------------------------------------------------------
# search with valid + rescore over an int8 store, the medoid, the int8 build
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_graph(corpus, base_pool):
    x = corpus[0][:N_BASE]
    jstore = jvs.encode(jnp.asarray(x), "int8")
    store = convert.store_from_jax(*(np.asarray(a) for a in jstore), device="cpu")
    valid = np.random.default_rng(6).random(N_BASE) < 0.85
    return x, jstore, store, valid


def test_medoid_over_an_int8_store_with_valid_matches_the_reference(int8_graph):
    _, jstore, store, valid = int8_graph
    for mask in (None, valid):
        want = int(jmedoid(jstore, None if mask is None else jnp.asarray(mask)))
        got = int(medoid(store, None if mask is None else torch.from_numpy(mask)))
        if got != want:  # a near-tie: both within fp32 error of the minimum
            c = store.dequant()[torch.from_numpy(mask) if mask is not None else slice(None)]
            d = ((store.dequant() - c.mean(0)) ** 2).sum(1)
            assert abs(float(d[got] - d[want])) <= 1e-5 * float(d[want])
        if mask is not None:
            assert valid[got]


@pytest.mark.parametrize("visited,cap", [("dense", None), ("hashed", 256)])
@pytest.mark.parametrize("precision", ["int8", "bf16"])
def test_search_valid_rescore_over_a_store_matches_the_reference(
    corpus, base_pool, int8_graph, visited, cap, precision
):
    _, q, _ = corpus
    x, _, _, valid = int8_graph
    jstore = jvs.encode(jnp.asarray(x), precision)
    store = convert.store_from_jax(
        *(None if a is None else np.asarray(a) for a in jstore), device="cpu"
    )
    entry = jmedoid(jstore, jnp.asarray(valid))
    kw = dict(k=K, ef=EF, visited=visited, visited_cap=cap)
    want = jsearch(
        jstore, base_pool.ids, jnp.asarray(q), entry=entry, valid=jnp.asarray(valid),
        rescore=jnp.asarray(x), **kw,
    )
    got = search(
        store, np.asarray(base_pool.ids), q, entry=np.asarray(entry), valid=valid,
        rescore=x, device="cpu", **kw,
    )
    assert _query_match(got.ids, want.ids) >= QUERY_MATCH
    same = (got.ids.numpy() == np.asarray(want.ids)).all(1)
    np.testing.assert_allclose(
        got.dists.numpy()[same], np.asarray(want.dists)[same], rtol=1e-5, atol=1e-5
    )
    assert not np.isin(got.ids.numpy(), np.nonzero(~valid)[0]).any()
    # rescored distances are exact fp32 distances of the returned ids
    ids = got.ids.numpy()
    exact = ((x[np.clip(ids, 0, None)] - q[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(got.dists.numpy(), exact, rtol=1e-5, atol=1e-5)


def test_static_int8_build_matches_the_reference(corpus):
    x, q, gt = corpus
    cfg = GRNNDConfig(s=8, r=16, t1=3, t2=3, pairs_per_vertex=16)
    key = jax.random.PRNGKey(4)
    jstore = jvs.encode(jnp.asarray(x), "int8")
    store = convert.store_from_jax(*(np.asarray(a) for a in jstore), device="cpu")
    jpool = jgrnnd.build_graph(key, jstore, jgrnnd.GRNNDConfig(**cfg._asdict()))
    pool = build_graph(store, cfg, draws=jax_draws(key, N, cfg), device="cpu")
    kw = dict(k=K, ef=EF, rescore=x)
    want = jrecall.recall_at_k(jsearch(jstore, jpool.ids, jnp.asarray(q), **kw).ids, gt)
    got = recall_at_k(search(store, pool.ids, q, device="cpu", **kw).ids, gt)
    assert abs(got - want) <= 0.02 and got >= 0.9, (got, want)


# ---------------------------------------------------------------------------
# vertex labels and filtered search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_labeled_index_matches_the_reference(corpus, base_pool, precision):
    """vertex_labels through construction and insert, label_words(), and
    filtered search and ground truth in label space, against the reference
    with its draws injected."""
    x, q, _ = corpus
    cfg = _dcfg(precision)
    vl = np.random.default_rng(7).integers(0, 30, N).astype(np.int32)
    vl[5] = 31  # a label on the int32 sign bit of word 0
    jidx = JDynamicIndex(jnp.asarray(x[:N_BASE]), base_pool, _jdcfg(cfg),
                         vertex_labels=jnp.asarray(vl[:N_BASE]), n_labels=40)
    b = N - N_BASE
    draws = localized_draws(jidx._key, [b + b * cfg.seed_k] * cfg.refine_rounds, CFG.r, 16)
    pool = Pool(torch.tensor(np.asarray(base_pool.ids)), torch.tensor(np.asarray(base_pool.dists)))
    tidx = DynamicIndex(x[:N_BASE], pool, cfg, draws=draws, device="cpu",
                        vertex_labels=vl[:N_BASE], n_labels=40)
    jidx.insert(jnp.asarray(x[N_BASE:]), vertex_labels=jnp.asarray(vl[N_BASE:]))
    tidx.insert(x[N_BASE:], vertex_labels=vl[N_BASE:])
    assert tidx.n_labels == jidx.n_labels == 40
    np.testing.assert_array_equal(tidx.vlabels.numpy(), jidx.vlabels)
    np.testing.assert_array_equal(tidx.label_words().numpy(), np.asarray(jidx.label_words()))
    fw = np.asarray(JL.random_query_filters(jax.random.PRNGKey(8), q.shape[0], 40, 0.2))
    want = jidx.search(jnp.asarray(q), k=K, ef=EF, filter=fw)
    got = tidx.search(q, k=K, ef=EF, filter=fw)
    assert _query_match(got.ids, want.ids) >= QUERY_MATCH
    # labels are rows of x here: every returned row carries an allowed label
    vw = pack_ids(vl, 40)
    assert predicate_fraction(got.ids, torch.from_numpy(fw), vw) == 1.0
    jgt, tgt = jidx.exact_knn(jnp.asarray(q), K, filter=fw), tidx.exact_knn(q, K, filter=fw)
    np.testing.assert_array_equal(tgt.numpy() < 0, np.asarray(jgt) < 0)
    assert filtered_recall_at_k(tgt, np.asarray(jgt)) >= 0.995
    assert filtered_recall_at_k(got.ids, tgt) >= 0.85
    # an unlabeled batch is searchable unfiltered and matched by no predicate
    tidx.draws = Draws(9, "cpu")  # past the recorded rounds
    new = tidx.insert(x[:20] + 0.01)
    assert (tidx.vlabels[tidx.size - 20 : tidx.size] == -1).all()
    res = tidx.search(q, k=K, ef=EF, filter=fw)
    assert not torch.isin(res.ids, new).any()


# ---------------------------------------------------------------------------
# the draws seam and what is not ported
# ---------------------------------------------------------------------------


def test_localized_pairs_seam():
    d = Draws(3, "cpu")
    si, sj = d.localized_pairs(0, 50, 16, 8)
    assert si.shape == sj.shape == (50, 8) and si.dtype == torch.int32
    assert int(si.min()) >= 0 and int(si.max()) < 16
    assert torch.equal(si, d.localized_pairs(0, 50, 16, 8)[0])  # stateless
    assert not torch.equal(si, d.localized_pairs(1, 50, 16, 8)[0])
    assert not torch.equal(si, d.slot_pairs(0, 0, None, 50, 16, 8)[0])
    rec = RecordedDraws(localized={0: (si.numpy(), sj.numpy())})
    assert torch.equal(rec.localized_pairs(0, 50, 16, 8)[1], sj)
    with pytest.raises(ValueError):
        rec.localized_pairs(0, 49, 16, 8)
    with pytest.raises(KeyError):
        rec.localized_pairs(1, 50, 16, 8)
    with pytest.raises(ValueError):
        rec.init_ids(4, 2)


def test_what_is_not_ported_raises(corpus, base_pool):
    x = corpus[0][:N_BASE]
    pool = Pool(torch.tensor(np.asarray(base_pool.ids)), torch.tensor(np.asarray(base_pool.dists)))
    # every part is ported now (group= and corpus_search in the last
    # slice); misuse of tier="host", layout= and vertex_labels= raises
    for kw, msg in (
        (dict(cfg=DynamicConfig(tier="host")), "quantized traversal tier"),
        (dict(cfg=DynamicConfig(tier="disk", precision="int8")), "tier"),
        (dict(cfg=DynamicConfig(layout="random")), "layout"),
        (dict(n_labels=4), "n_labels without vertex_labels"),
        (dict(cfg=DynamicConfig(precision="fp16")), "precision"),
    ):
        with pytest.raises(ValueError, match=msg):
            DynamicIndex(x, pool, device="cpu", **kw)
    idx = DynamicIndex(x, pool, device="cpu")
    got, want = idx.corpus_search(x[:2], 2), idx.search(x[:2])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for call in (
        lambda: idx.corpus_search(x[:2], 2, filter=np.zeros(2, np.int32)),
        lambda: idx.search(x[:2], filter=np.zeros(2, np.int32)),
        lambda: idx.exact_knn(x[:2], 3, filter=np.zeros(2, np.int32)),
        lambda: idx.insert(x[:2], vertex_labels=np.zeros(2, np.int32)),
        lambda: idx.label_words(),
    ):
        with pytest.raises(ValueError, match="without vertex labels"):
            call()
