"""repro_torch.core.layout against repro.core.layout, and its equivalence tier.

The layout pass is integer work on the graph (packing, orderings, detour
counts on the same fp32 pool distances), so `pack_adjacency`,
`unpack_adjacency`, `order_permutation` (bfs and hub, with dead vertices),
`detour_counts` and `prune_adjacency` equal the reference's exactly. Within
the port, `optimize().search` returns bitwise the unoptimized search's ids,
dists and n_expanded (dense visited, and hashed at visited_cap >= N) on
fp32, bf16 and int8 + rescore traversal, filtered and not. Against the
reference's optimized index from the same entry: the permutation and the
packed graph are equal, and searches agree as in tests/test_torch_search.py
(at least 97% of queries identical, distances to rtol 1e-5). The dynamic
index's layout pass equals the reference's slot by slot.
`OptimizedIndex.distributed_search` over a one-rank gloo group returns the
plain search bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import grnnd as jgrnnd
from repro.core import labels as JL
from repro.core import layout as JLY
from repro.core import vecstore as JVS
from repro.core.dynamic import DynamicConfig as JDynamicConfig
from repro.core.dynamic import DynamicIndex as JDynamicIndex
from repro.core.search import medoid as jmedoid
from repro.data import synthetic as jsynthetic
from repro_torch import convert
from repro_torch.core import DynamicConfig, DynamicIndex, encode, search
from repro_torch.core import layout as LY
from repro_torch.core.labels import encode_labels, random_query_filters

torch.set_num_threads(1)

K, EF, N, NQ = 10, 32, 400, 24
CFG = jgrnnd.GRNNDConfig(s=8, r=16, t1=2, t2=3, pairs_per_vertex=16)


@pytest.fixture(scope="module")
def case():
    x = jsynthetic.make_preset(jax.random.PRNGKey(0), "tiny", N)
    q = jsynthetic.queries_from(jax.random.PRNGKey(1), x, NQ)
    pool = jgrnnd.build_graph(jax.random.PRNGKey(2), x, CFG)
    tpool, tx = convert.from_jax(pool.ids, pool.dists, x, device="cpu")
    return x, q, pool, tx, torch.from_numpy(np.array(q)), tpool


def _same(a, b):
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def _holey(seed, n=60, r=12):
    """Pools with -1 holes anywhere in a row."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, n, (n, r)).astype(np.int32)
    g[rng.random((n, r)) < 0.35] = -1
    g[3] = -1  # an empty row
    return g


@pytest.mark.parametrize("degree", [None, 4, 12, 15])
def test_pack_and_unpack_equal_the_reference(degree):
    g = _holey(degree or 0)
    want = JLY.pack_adjacency(g, degree)
    got = LY.pack_adjacency(g, degree)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert LY.packed_degree(g) == JLY.packed_degree(g)
    np.testing.assert_array_equal(
        LY.unpack_adjacency(got, 20).numpy(), JLY.unpack_adjacency(want, 20)
    )


@pytest.mark.parametrize("order", ["bfs", "hub", "identity"])
def test_order_permutation_equals_the_reference(case, order):
    _, _, pool, _, _, tpool = case
    valid = np.ones(N, bool)
    valid[::7] = False
    for v, entry in ((None, 3), (valid, 5), (valid, 7)):  # slot 7 is dead: no BFS levels
        want = JLY.order_permutation(np.asarray(pool.ids), order, entry=entry, valid=v)
        got = LY.order_permutation(
            tpool.ids, order, entry=entry, valid=None if v is None else torch.from_numpy(v)
        )
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        LY.order_permutation(tpool.ids, "random")


def test_detour_counts_and_pruning_equal_the_reference(case):
    _, _, pool, _, _, tpool = case
    want = JLY.detour_counts(pool.ids, pool.dists, chunk=64)
    got = LY.detour_counts(tpool.ids, tpool.dists, chunk=64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() > 0
    for degree in (6, 10):
        np.testing.assert_array_equal(
            LY.prune_adjacency(tpool.ids, tpool.dists, degree, chunk=100).numpy(),
            JLY.prune_adjacency(pool.ids, pool.dists, degree, chunk=100),
        )


@pytest.mark.parametrize("order", ["bfs", "hub"])
@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_optimized_search_equals_the_plain_search_bitwise(case, precision, order):
    _, _, _, tx, tq, tpool = case
    vs = tx if precision == "fp32" else encode(tx, precision)
    rescore = None if precision == "fp32" else tx
    base = search(vs, tpool.ids, tq, k=K, ef=EF, rescore=rescore, device="cpu")
    opt = LY.optimize(vs, tpool, order=order, rescore=rescore, device="cpu")
    assert opt.order == order and not opt.pruned and opt.degree == LY.packed_degree(tpool.ids)
    _same(base, opt.search(tq, k=K, ef=EF))
    hashed = dict(k=K, ef=EF, visited="hashed", visited_cap=N)
    _same(search(vs, tpool.ids, tq, rescore=rescore, device="cpu", **hashed),
          opt.search(tq, **hashed))


def test_optimized_filtered_search_equals_the_plain_search_bitwise(case):
    _, _, _, tx, tq, tpool = case
    g = torch.Generator().manual_seed(9)
    store = encode_labels(torch.randint(0, 12, (N,), generator=g), 12)
    fw = random_query_filters(g, NQ, 12, 0.25)
    vs = encode(tx, "int8")
    base = search(vs, tpool.ids, tq, k=K, ef=EF, rescore=tx, labels=store, filter=fw,
                  device="cpu")
    opt = LY.optimize(vs, tpool, order="bfs", rescore=tx, labels=store, device="cpu")
    _same(base, opt.search(tq, k=K, ef=EF, filter=fw))
    # an explicit permutation, and one that is not a bijection
    perm = np.random.default_rng(1).permutation(N)
    custom = LY.optimize(vs, tpool, permutation=perm, rescore=tx, labels=store, device="cpu")
    assert custom.order == "custom"
    _same(base, custom.search(tq, k=K, ef=EF, filter=fw))
    with pytest.raises(ValueError):
        LY.optimize(vs, tpool, permutation=np.zeros(N, np.int64), device="cpu")
    # the query-sharded search over a one-rank gloo group: the same result
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        _same(base, opt.distributed_search(tq, k=K, ef=EF, filter=fw))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("order", ["bfs", "hub"])
def test_optimize_matches_the_reference(case, order):
    x, q, pool, tx, tq, tpool = case
    jvs = JVS.encode(x, "int8")
    vs = convert.store_from_jax(*(np.asarray(a) for a in jvs), device="cpu")
    entry = jmedoid(jvs)
    jstore = JL.encode_labels(jax.random.randint(jax.random.PRNGKey(4), (N,), 0, 10), 10)
    fw = JL.random_query_filters(jax.random.PRNGKey(5), NQ, 10, 0.3)
    jopt = JLY.optimize(jvs, pool, order=order, rescore=x, labels=jstore, entry=entry)
    opt = LY.optimize(vs, tpool, order=order, rescore=tx, labels=np.asarray(jstore.words),
                      entry=int(entry), device="cpu")
    for name in ("graph_ids", "inv", "perm", "entry", "vwords"):
        np.testing.assert_array_equal(getattr(opt, name).numpy(), np.asarray(getattr(jopt, name)))
    assert torch.equal(opt.x.data, torch.from_numpy(np.asarray(jopt.x.data)))
    # the reference's optimized index carried over searches as the port's own
    carried = convert.optimized_from_jax(
        x=tuple(np.asarray(a) for a in jopt.x), graph_ids=jopt.graph_ids, entry=jopt.entry,
        inv=jopt.inv, perm=jopt.perm, rescore=np.asarray(jopt.rescore), vwords=jopt.vwords,
        order=order, device="cpu",
    )
    for f in (None, fw):
        want = jopt.search(q, k=K, ef=EF, filter=f)
        got = opt.search(tq, k=K, ef=EF, filter=None if f is None else np.asarray(f))
        _same(got, carried.search(tq, k=K, ef=EF, filter=None if f is None else np.asarray(f)))
        same = (got.ids.numpy() == np.asarray(want.ids)).all(1)
        assert same.mean() >= 0.97
        np.testing.assert_allclose(got.dists.numpy()[same], np.asarray(want.dists)[same],
                                   rtol=1e-5)
        assert (got.ids.numpy() < N).all()  # original numbering


def test_dynamic_layout_matches_the_reference_slot_by_slot(case):
    x, q, pool, tx, tq, tpool = case
    labels = np.random.default_rng(8).integers(0, 9, N).astype(np.int32)
    fw = np.random.default_rng(9).integers(0, 9, NQ).astype(np.int32)
    cfg = DynamicConfig(precision="int8", layout="bfs", compact_threshold=0.9)
    jidx = JDynamicIndex(x, pool, JDynamicConfig(**cfg._asdict()),
                         vertex_labels=jnp.asarray(labels), n_labels=9)
    idx = DynamicIndex(tx, tpool, cfg, device="cpu", vertex_labels=labels, n_labels=9)
    jlabels = np.asarray(jidx.labels)

    def check():
        assert idx.size == jidx.size and int(idx._entry) == int(jidx._entry)
        np.testing.assert_array_equal(idx.labels.numpy(), jidx.labels)
        np.testing.assert_array_equal(idx.vlabels.numpy(), jidx.vlabels)
        np.testing.assert_array_equal(idx.valid.numpy(), np.asarray(jidx.valid))
        np.testing.assert_array_equal(idx.store.data.numpy(), np.asarray(jidx.store.data))
        np.testing.assert_array_equal(idx.x.numpy(), np.asarray(jidx.x))
        np.testing.assert_array_equal(idx.pool.ids.numpy(), np.asarray(jidx.pool.ids))
        np.testing.assert_array_equal(idx.label_words().numpy(), np.asarray(jidx.label_words()))

    check()
    assert not np.array_equal(jlabels[:N], np.arange(N))  # the slots were renumbered
    # a delete finds its slots through the permuted label table
    dels = np.arange(0, N, 3)
    assert idx.delete(dels) == jidx.delete(dels) == dels.size
    idx.compact()
    jidx.compact()  # both re-run the layout over the kept rows
    check()
    idx.optimize_layout("hub")
    jidx.optimize_layout("hub")
    check()
    want = jidx.search(jnp.asarray(q), k=K, ef=EF, filter=fw)
    got = idx.search(tq, k=K, ef=EF, filter=fw)
    assert ((got.ids.numpy() == np.asarray(want.ids)).all(1)).mean() >= 0.97
    assert not np.isin(got.ids.numpy(), dels).any()
