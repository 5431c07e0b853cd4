"""The host rescore tier of repro_torch against its device tier and repro.

`vecstore.HostTier` keeps the fp32 rescore rows in host memory; the search
gathers the final ef candidates' rows there and re-ranks them with the
device tier's formula (`search._rescore_merge`). So, within the port:

  * host tier == device tier bitwise (ids, dists, n_expanded) on fp32,
    bf16 and int8 traversal, filtered, hashed with collisions, and under an
    optimized layout;
  * `DynamicIndex(tier="host")` == `tier="device"` bitwise through insert,
    delete and compaction, with no fp32 row on the device;

and against the reference's host-tier search on the same graph: at least
97% of queries return identical ids, distances to rtol 1e-5 where they do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grnnd as jgrnnd
from repro.core import vecstore as JVS
from repro.core.search import medoid as jmedoid
from repro.core.search import search as jsearch
from repro_torch import convert
from repro_torch.core import (
    PLACEMENTS,
    DynamicConfig,
    DynamicIndex,
    HostTier,
    encode,
    encode_labels,
    optimize,
    predicate_fraction,
    random_query_filters,
    search,
)
from repro_torch.core.draws import Draws
from repro_torch.core.vecstore import is_host
from repro_torch.data import synthetic

torch.set_num_threads(1)

N, NQ, K, EF = 700, 48, 10, 32


@pytest.fixture(scope="module")
def case():
    g = torch.Generator().manual_seed(11)
    x = synthetic.make_preset(g, "sift-like", N)
    q = synthetic.queries_from(g, x, NQ)
    pool = jgrnnd.build_graph(
        jax.random.PRNGKey(12), jnp.asarray(x.numpy()),
        jgrnnd.GRNNDConfig(s=8, r=16, t1=3, t2=3, pairs_per_vertex=16),
    )
    ids = torch.from_numpy(np.array(pool.ids))
    return x, q, pool, ids


def _same(a, b):
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_host_tier_placement_and_accounting(case):
    x, _, _, _ = case
    assert PLACEMENTS == JVS.PLACEMENTS
    ht = HostTier(x)
    assert is_host(ht) and not is_host(x)
    assert ht.data.device.type == "cpu" and not ht.data.is_pinned()  # no card: no pinning
    assert ht.data.data_ptr() == x.data_ptr()  # a CPU fp32 tensor is wrapped, not copied
    assert (ht.n, ht.dim, ht.shape) == (N, x.shape[1], tuple(x.shape))
    assert ht.device_bytes() == 0 and ht.host_bytes() == N * x.shape[1] * 4
    store = encode(x, "int8")
    assert torch.equal(HostTier(store).data, store.dequant())  # pre-dequantized rows


def test_host_tier_gather_masks_pad_slots(case):
    x, _, _, _ = case
    ht = HostTier(x)
    ids = torch.tensor([[3, -1, 7], [-1, -1, 0]], dtype=torch.int32)
    out = ht.gather(ids)
    assert out.shape == (2, 3, x.shape[1]) and out.device == ids.device
    assert torch.equal(out[0, 0], x[3]) and torch.equal(out[0, 2], x[7])
    assert torch.equal(out[1, 2], x[0])
    assert not out[0, 1].any() and not out[1, 0].any() and not out[1, 1].any()
    assert ht.fetched_rows == 3 and ht.gather_seconds > 0  # -1 slots ship nothing
    # the reference gathers the same rows
    want = np.asarray(JVS.HostTier(jnp.asarray(x.numpy())).gather(ids.numpy()))
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("visited,cap", [("dense", None), ("hashed", 64)])
def test_host_tier_equals_the_device_tier_bitwise(case, precision, visited, cap):
    x, q, _, ids = case
    vs = encode(x, precision)
    kw = dict(k=K, ef=EF, visited=visited, visited_cap=cap, device="cpu")
    ht = HostTier(x)
    _same(search(vs, ids, q, rescore=x, **kw), search(vs, ids, q, rescore=ht, **kw))
    assert 0 < ht.fetched_rows <= NQ * EF


def test_host_tier_filtered_equals_the_device_tier_bitwise(case):
    x, q, _, ids = case
    vs = encode(x, "int8")
    g = torch.Generator().manual_seed(3)
    store = encode_labels(torch.randint(0, 20, (N,), generator=g), 20)
    fw = random_query_filters(g, NQ, 20, 0.25)
    kw = dict(k=K, ef=EF, labels=store, filter=fw, device="cpu")
    dev = search(vs, ids, q, rescore=x, **kw)
    host = search(vs, ids, q, rescore=HostTier(x), **kw)
    _same(dev, host)
    assert predicate_fraction(host.ids, fw, store.words) == 1.0


def test_host_tier_under_a_layout_equals_the_device_tier_bitwise(case):
    x, q, pool, _ = case
    vs = encode(x, "int8")
    opt = optimize(vs, pool, order="hub", rescore=x, device="cpu")
    dev = opt.search(q, k=K, ef=EF)
    host = opt._replace(rescore=HostTier(opt.rescore)).search(q, k=K, ef=EF)
    _same(dev, host)
    # and an optimized index made with the host tier holds it permuted
    opt_h = optimize(vs, pool, order="hub", rescore=HostTier(x), device="cpu")
    assert is_host(opt_h.rescore)
    _same(dev, opt_h.search(q, k=K, ef=EF))


def test_host_tier_search_matches_the_reference(case):
    x, q, pool, ids = case
    jx = jnp.asarray(x.numpy())
    jvs = JVS.encode(jx, "int8")
    vs = convert.store_from_jax(*(np.asarray(a) for a in jvs), device="cpu")
    entry = jmedoid(jvs)
    want = jsearch(jvs, pool.ids, jnp.asarray(q.numpy()), k=K, ef=EF, entry=entry,
                   rescore=JVS.HostTier(jx))
    got = search(vs, ids, q, k=K, ef=EF, entry=int(entry), rescore=HostTier(x), device="cpu")
    same = (got.ids.numpy() == np.asarray(want.ids)).all(1)
    assert same.mean() >= 0.97
    np.testing.assert_allclose(got.dists.numpy()[same], np.asarray(want.dists)[same], rtol=1e-5)


def test_dynamic_host_tier_equals_the_device_tier_through_churn(case):
    x, q, pool, _ = case
    base = 600
    jpool = jgrnnd.build_graph(
        jax.random.PRNGKey(13), jnp.asarray(x[:base].numpy()),
        jgrnnd.GRNNDConfig(s=8, r=16, t1=3, t2=3, pairs_per_vertex=16),
    )
    bpool = convert.from_jax(jpool.ids, jpool.dists, x[:base], device="cpu")[0]
    labels = torch.randint(0, 12, (N,), generator=torch.Generator().manual_seed(5))
    fw = random_query_filters(torch.Generator().manual_seed(6), NQ, 12, 0.3)
    idx = {}
    for tier in ("device", "host"):
        cfg = DynamicConfig(seed_k=8, seed_ef=EF, precision="int8", tier=tier,
                            compact_threshold=0.9)
        idx[tier] = DynamicIndex(x[:base], bpool, cfg, draws=Draws(7, "cpu"), device="cpu",
                                 vertex_labels=labels[:base], n_labels=12)
    host = idx["host"]
    assert is_host(host._rescore_tier()) and host._rescore_tier().device_bytes() == 0

    def check():
        for f in (None, fw):
            _same(idx["device"].search(q, k=K, ef=EF, filter=f),
                  host.search(q, k=K, ef=EF, filter=f))

    check()
    for tier in idx:
        idx[tier].insert(x[base:], vertex_labels=labels[base:])
    check()
    for tier in idx:
        idx[tier].delete(np.arange(0, N, 4))
    check()
    for tier in idx:
        idx[tier].compact()
    check()
    assert torch.equal(host.x, idx["device"].x)
    assert host._rescore_tier().fetched_rows > 0
