"""Filtered search in repro_torch against repro on the same inputs.

  * `search_expand_ref` with the label predicate against the reference's
    Pallas kernel in interpret mode, on fp32 / bf16 / int8 rows, with and
    without the tombstone mask, at W = 1 and 3 words, H = 1 and
    H < HASH_PROBES:
    ids, fresh and `allowed` exactly equal, distances to rtol / atol 1e-5
    (fp32 sums in another order);
  * route-through: the predicate changes neither ids, dists nor fresh;
  * filtered `search` against `repro.core.search.search(labels=, filter=)`
    on the reference's graph, dense and hashed: at least 97% of queries
    return identical ids (near-ties aside), distances to rtol 1e-5 where
    they do, recall within 0.01, and the predicate fraction exactly 1.0;
  * at a saturating ef the result equals `filtered_brute_force` over the
    allowed rows; `overfetch` widens the working ef as the reference's, and
    `overfetch_ef` is the reference's policy; the filter composes with the
    tombstone mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grnnd as jgrnnd
from repro.core import labels as JL
from repro.core import vecstore as JVS
from repro.core.search import medoid as jmedoid
from repro.core.search import overfetch_ef as j_overfetch_ef
from repro.core.search import search as jsearch
from repro.data import synthetic as jsynthetic
from repro.kernels.search_expand import search_expand_pallas
from repro_torch import convert
from repro_torch.core import labels as L
from repro_torch.core.search import _table_insert, medoid, overfetch_ef, search
from repro_torch.kernels import ref

torch.set_num_threads(1)

QUERY_MATCH = 0.97
RECALL_GAP = 0.01


def _expand_case(seed, q, r, n, d, h, n_labels, sel):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    nbrs = rng.integers(-1, n, (q, r)).astype(np.int32)
    table = torch.full((q, h), -1, dtype=torch.int32)
    _table_insert(table, torch.from_numpy(np.where(rng.random((q, r)) < 0.5, nbrs, -1)))
    valid = rng.random(n) < 0.8
    vwords = np.asarray(JL.pack_ids(jnp.asarray(rng.integers(0, n_labels, n)), n_labels))
    fwords = np.asarray(JL.random_query_filters(jax.random.PRNGKey(seed), q, n_labels, sel))
    return x, queries, nbrs, table.numpy(), valid, vwords, fwords


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize(
    "q,r,n,d,h,n_labels,sel",
    [
        (5, 7, 50, 33, 3, 70, 0.2),  # W = 3, D not a multiple of 4, H < HASH_PROBES
        (4, 8, 40, 16, 1, 8, 0.5),  # W = 1, H = 1 (the dense path's table)
    ],
)
def test_expand_filter_matches_the_interpret_kernel(precision, masked, q, r, n, d, h, n_labels, sel):
    x, queries, nbrs, table, valid, vwords, fwords = _expand_case(
        23 + n, q, r, n, d, h, n_labels, sel
    )
    jstore = JVS.encode(jnp.asarray(x), precision)
    store = convert.store_from_jax(
        *(None if a is None else np.asarray(a) for a in jstore), device="cpu"
    )
    vmask = valid if masked else None
    want = search_expand_pallas(
        jstore.data, jnp.asarray(queries), jnp.asarray(nbrs), jnp.asarray(table),
        None if vmask is None else jnp.asarray(vmask), jstore.scale, jstore.offset,
        jnp.asarray(vwords), jnp.asarray(fwords), interpret=True,
    )
    t = torch.from_numpy
    got = ref.search_expand_ref(
        store.data, t(queries), t(nbrs), t(table), None if vmask is None else t(vmask),
        store.scale, store.offset, t(vwords), t(fwords),
    )
    assert len(got) == len(want) == 4
    for i in (0, 2, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    assert got[3].any() and (got[0] >= 0).sum() > got[3].sum()  # both outcomes occur
    # route-through: the predicate leaves ids, dists and fresh as they were
    plain = ref.search_expand_ref(
        store.data, t(queries), t(nbrs), t(table), None if vmask is None else t(vmask),
        store.scale, store.offset,
    )
    for a, b in zip(got[:3], plain):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def labeled_graph():
    x = jsynthetic.make_preset(jax.random.PRNGKey(0), "tiny", 900)
    q = jsynthetic.queries_from(jax.random.PRNGKey(1), x, 96)
    cfg = jgrnnd.GRNNDConfig(s=8, r=16, t1=3, t2=3, pairs_per_vertex=16)
    pool = jgrnnd.build_graph(jax.random.PRNGKey(2), x, cfg)
    store = JL.encode_labels(jax.random.randint(jax.random.PRNGKey(3), (900,), 0, 25), 25)
    fw = JL.random_query_filters(jax.random.PRNGKey(4), 96, 25, 0.2)
    tpool, tx = convert.from_jax(pool.ids, pool.dists, x, device="cpu")
    tstore = convert.labels_from_jax(store.words, store.labels, device="cpu")
    return x, pool, q, store, fw, tx, tpool, torch.from_numpy(np.array(q)), tstore


def _query_match(a, b) -> float:
    return float((np.asarray(a) == np.asarray(b)).all(1).mean())


@pytest.mark.parametrize("visited,cap", [("dense", None), ("hashed", None), ("hashed", 64)])
def test_filtered_search_matches_the_reference(labeled_graph, visited, cap):
    x, pool, q, store, fw, tx, tpool, tq, tstore = labeled_graph
    entry = jmedoid(x)
    kw = dict(k=10, ef=32, visited=visited, visited_cap=cap)
    want = jsearch(x, pool.ids, q, entry=entry, labels=store, filter=fw, **kw)
    got = search(
        tx, tpool.ids, tq, entry=int(entry), labels=tstore, filter=np.asarray(fw),
        device="cpu", **kw,
    )
    fwt = torch.from_numpy(np.asarray(fw))
    assert L.predicate_fraction(got.ids, fwt, tstore.words) == 1.0
    assert _query_match(got.ids, want.ids) >= QUERY_MATCH
    same = (got.ids.numpy() == np.asarray(want.ids)).all(1)
    np.testing.assert_allclose(got.dists.numpy()[same], np.asarray(want.dists)[same], rtol=1e-5)
    gt = L.filtered_brute_force(tx, tq, fwt, tstore.words, 10)
    rec = L.filtered_recall_at_k(got.ids, gt)
    assert abs(rec - L.filtered_recall_at_k(np.asarray(want.ids), gt)) <= RECALL_GAP
    assert rec >= 0.9, rec


def test_filtered_search_takes_every_predicate_form(labeled_graph):
    _, _, _, store, _, tx, tpool, tq, tstore = labeled_graph
    ids = np.random.default_rng(5).integers(0, 25, tq.shape[0]).astype(np.int32)
    member = np.zeros((tq.shape[0], 25), bool)
    member[np.arange(tq.shape[0]), ids] = True
    outs = [
        search(tx, tpool.ids, tq, k=10, ef=32, labels=lab, filter=f, device="cpu")
        for lab, f in (
            (tstore, ids),
            (tstore.words, member),
            (tstore, L.pack_ids(ids, 25).numpy()),
        )
    ]
    for res in outs[1:]:
        assert torch.equal(res.ids, outs[0].ids) and torch.equal(res.dists, outs[0].dists)
    assert L.predicate_fraction(outs[0].ids, L.pack_ids(ids, 25), tstore.words) == 1.0


@pytest.mark.parametrize("label_seed,sel", [(40, 0.05), (42, 0.2), (44, 0.6)])
def test_saturating_ef_equals_filtered_brute_force(label_seed, sel):
    g = torch.Generator().manual_seed(label_seed)
    n = 160
    x = jsynthetic.make_preset(jax.random.PRNGKey(30), "tiny", n)
    pool = jgrnnd.build_graph(
        jax.random.PRNGKey(31), x, jgrnnd.GRNNDConfig(s=8, r=16, t1=3, t2=3, pairs_per_vertex=16)
    )
    tpool, tx = convert.from_jax(pool.ids, pool.dists, x, device="cpu")
    q = torch.from_numpy(np.array(jsynthetic.queries_from(jax.random.PRNGKey(32), x, 12)))
    store = L.encode_labels(torch.randint(0, 24, (n,), generator=g), 24)
    fw = L.random_query_filters(g, 12, 24, sel)
    # the claim is about vertices the beam can reach from the entry
    entry = int(medoid(tx))
    reach = np.zeros(n, bool)
    stack, reach[entry] = [entry], True
    while stack:
        for u in tpool.ids[stack.pop()].tolist():
            if u >= 0 and not reach[u]:
                reach[u] = True
                stack.append(u)
    vw = torch.where(torch.from_numpy(reach)[:, None], store.words, 0)
    res = search(tx, tpool.ids, q, k=10, ef=n, max_steps=2 * n, labels=store, filter=fw,
                 device="cpu")
    gt = L.filtered_brute_force(tx, q, fw, vw, 10)
    np.testing.assert_array_equal(np.sort(res.ids.numpy(), 1), np.sort(gt.numpy(), 1))
    assert L.filtered_recall_at_k(res.ids, gt) == 1.0


def test_overfetch_widens_like_the_reference(labeled_graph):
    x, pool, q, _, _, tx, tpool, tq, _ = labeled_graph
    store = JL.encode_labels(jax.random.randint(jax.random.PRNGKey(53), (900,), 0, 4), 4)
    fw = JL.random_query_filters(jax.random.PRNGKey(54), 96, 4, 0.25)
    tstore = convert.labels_from_jax(store.words, store.labels, device="cpu")
    entry = jmedoid(x)
    got, want = {}, {}
    for of in (1, 4):
        kw = dict(k=10, ef=10, overfetch=of)
        want[of] = jsearch(x, pool.ids, q, entry=entry, labels=store, filter=fw, **kw)
        got[of] = search(tx, tpool.ids, tq, entry=int(entry), labels=tstore,
                         filter=np.asarray(fw), device="cpu", **kw)
        assert _query_match(got[of].ids, want[of].ids) >= QUERY_MATCH
    assert int((got[4].ids >= 0).sum()) >= int((got[1].ids >= 0).sum())
    gt = L.filtered_brute_force(tx, tq, torch.from_numpy(np.asarray(fw)), tstore.words, 10)
    assert L.filtered_recall_at_k(got[4].ids, gt) >= L.filtered_recall_at_k(got[1].ids, gt)
    for args in [(10**6, 10, 0.01, 64), (10**6, 10, 0.1, 64), (10**6, 10, 0.5, 64),
                 (300, 10, 0.01, 64), (10**6, 10, 0.9, 128), (900, 5, 0.003, 16)]:
        assert overfetch_ef(*args) == j_overfetch_ef(*args)
    assert [overfetch_ef(10**6, 10, s, 64) for s in (0.5, 0.1, 0.01)] == [80, 400, 512]


def test_filter_composes_with_tombstones(labeled_graph):
    x, pool, q, store, fw, tx, tpool, tq, tstore = labeled_graph
    valid = np.random.default_rng(6).random(900) < 0.7
    entry = jmedoid(x, jnp.asarray(valid))
    kw = dict(k=10, ef=32)
    want = jsearch(x, pool.ids, q, entry=entry, valid=jnp.asarray(valid), labels=store,
                   filter=fw, **kw)
    got = search(tx, tpool.ids, tq, entry=int(entry), valid=valid, labels=tstore,
                 filter=np.asarray(fw), device="cpu", **kw)
    ids = got.ids.numpy()
    ok = L.allowed_mask(ids, torch.from_numpy(np.asarray(fw)), tstore.words).numpy()
    assert ((ids < 0) | (ok & valid[np.clip(ids, 0, None)])).all()
    assert _query_match(ids, want.ids) >= QUERY_MATCH
