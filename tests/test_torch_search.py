"""repro_torch.core.search against repro.core.search on the same graph.

The reference builds the graph; `convert.from_jax` hands it to the port, and
both search it from the same entry. Per step the only float work is the
query->neighbor distance (fp32 sums in another order, max rel. error ~4e-7),
so ids, distances and n_expanded must agree except where two candidates tie
within that error: at least 98% of queries give identical ids and
n_expanded, and every returned distance agrees to rtol 1e-5 where the ids
do. The visited table is integer work: `_table_insert` and the column loop
of `ref.visited_insert_ref` equal the reference exactly (on the CPU the
insert never reaches the kernel launcher), and hashed search with
visited_cap >= N equals dense.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grnnd as jgrnnd
from repro.core.search import _table_insert as j_table_insert
from repro.core.search import _table_member as j_table_member
from repro.core.search import default_visited_cap as j_default_visited_cap
from repro.core.search import medoid as jmedoid
from repro.core.search import search as jsearch
from repro.data import synthetic as jsynthetic
from repro_torch import convert, trace
from repro_torch.core import labels as L
from repro_torch.core.search import (
    EF_CEILING,
    _table_insert,
    _table_member,
    default_visited_cap,
    medoid,
    search,
)
from repro_torch.kernels import _build, ops, ref
from test_torch_cuda import insert_cases

# the suite runs in parallel workers: one intra-op thread each keeps torch
# from oversubscribing the cores the JAX tests share
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graph():
    x = jsynthetic.make_preset(jax.random.PRNGKey(0), "tiny", 900)
    q = jsynthetic.queries_from(jax.random.PRNGKey(1), x, 96)
    cfg = jgrnnd.GRNNDConfig(s=8, r=16, t1=3, t2=3, pairs_per_vertex=16)
    pool = jgrnnd.build_graph(jax.random.PRNGKey(2), x, cfg)
    tpool, tx = convert.from_jax(pool.ids, pool.dists, x, device="cpu")
    return x, pool, q, tx, tpool, torch.from_numpy(np.array(q))


@pytest.mark.parametrize(
    "visited,cap", [("dense", None), ("hashed", None), ("hashed", 64), ("hashed", 32)]
)
@pytest.mark.parametrize("ef", [16, 48])
def test_search_matches_reference_on_the_same_graph(graph, visited, cap, ef):
    x, pool, q, tx, tpool, tq = graph
    entry = jmedoid(x)
    want = jsearch(x, pool.ids, q, k=10, ef=ef, entry=entry, visited=visited, visited_cap=cap)
    got = search(
        tx,
        tpool.ids,
        tq,
        k=10,
        ef=ef,
        entry=int(entry),
        visited=visited,
        visited_cap=cap,
        device="cpu",
    )
    assert got.ids.dtype == torch.int32 and got.n_expanded.dtype == torch.int32
    wi, gi = np.asarray(want.ids), got.ids.numpy()
    same = (wi == gi).all(1) & (np.asarray(want.n_expanded) == got.n_expanded.numpy())
    assert same.mean() >= 0.98, same.mean()
    np.testing.assert_allclose(got.dists.numpy()[same], np.asarray(want.dists)[same], rtol=1e-5)


def test_small_visited_table_re_enters_ids(graph):
    """A 32-slot table at ef 48 misses inserts, so ids come back as fresh
    and re-enter the beam: more expansions than the exact dense set, and
    the beam's expanded flags (carried through the merge) still match the
    reference's search."""
    _, _, _, tx, tpool, tq = graph
    small = search(tx, tpool.ids, tq, ef=48, visited="hashed", visited_cap=32, device="cpu")
    dense = search(tx, tpool.ids, tq, ef=48, visited="dense", device="cpu")
    assert int(small.n_expanded.sum()) > int(dense.n_expanded.sum())
    assert bool((small.n_expanded >= dense.n_expanded).all())


def test_medoid_matches_reference(graph):
    x, _, _, tx, _, _ = graph
    assert int(medoid(tx)) == int(jmedoid(x))


@pytest.mark.parametrize("ef", [16, 48])
def test_hashed_at_full_cap_equals_dense(graph, ef):
    _, _, _, tx, tpool, tq = graph
    dense = search(tx, tpool.ids, tq, ef=ef, visited="dense", device="cpu")
    hashed = search(tx, tpool.ids, tq, ef=ef, visited="hashed", visited_cap=900, device="cpu")
    for a, b in zip(dense, hashed):
        assert torch.equal(a, b)


@pytest.mark.parametrize("h", [8, 64])
def test_table_insert_equals_reference_exactly(h):
    rng = np.random.default_rng(h)
    table = np.full((12, h), -1, np.int32)
    want = jnp.asarray(table)
    got = torch.from_numpy(table.copy())
    for _ in range(4):  # repeated inserts fill the tables past their windows
        ids = rng.integers(-1, 300, (12, 16)).astype(np.int32)
        want = jax.jit(j_table_insert)(want, jnp.asarray(ids))
        _table_insert(got, torch.from_numpy(ids))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        member = _table_member(got, torch.from_numpy(ids)).numpy()
        np.testing.assert_array_equal(member, np.asarray(j_table_member(want, jnp.asarray(ids))))


@pytest.mark.parametrize("h", [1, 3, 8, 64])
def test_visited_insert_ref_equals_reference_exactly(h):
    rng = np.random.default_rng(1000 + h)
    table = np.full((12, h), -1, np.int32)
    prefill = rng.random((12, h)) < 0.25
    table[prefill] = rng.integers(0, 20 * h, int(prefill.sum()))
    want = jnp.asarray(table)
    got = torch.from_numpy(table.copy())
    for _ in range(3):  # repeated steps fill the tables past their windows
        ids = insert_cases(rng, 12, h, 16)
        want = jax.jit(j_table_insert)(want, jnp.asarray(ids))
        out = ref.visited_insert_ref(got, torch.from_numpy(ids))
        assert out is got
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["auto", "ref"])
def test_table_insert_on_the_cpu_never_launches_a_kernel(monkeypatch, name):
    def refuse(kernel, *args):
        raise AssertionError(f"{kernel} reached the kernel launcher from a CPU table")

    monkeypatch.setattr(_build, "launch", refuse)
    rng = np.random.default_rng(7)
    table = torch.full((10, 32), -1, dtype=torch.int32)
    want = table.clone()
    scope = ops.backend("ref") if name == "ref" else contextlib.nullcontext()
    with scope:
        for _ in range(3):
            ids = torch.from_numpy(insert_cases(rng, 10, 32, 24))
            # a column slice, as the search's entry insert and the tests pass
            assert _table_insert(table, ids[:, ::2]) is table
            ref.visited_insert_ref(want, ids[:, ::2].contiguous())
    assert torch.equal(table, want)


def _blocking_search(x, graph_ids, q, entry, *, k, ef, max_steps, visited, valid, vwords, fwords):
    """The beam loop as it ran with a blocking frontier test: each step runs
    only after the host has read that some query still has a frontier, and
    the expanded flag is written by indexing. (ids, dists, n_expanded) of
    the k best, and the steps run."""
    nq, filtered = q.shape[0], fwords is not None
    rows = torch.arange(nq)
    d0 = ops.rowwise_sqdist(q, x[entry].expand(nq, -1).contiguous())
    if valid is not None:
        d0 = torch.where(valid[entry], d0, torch.inf)
    ids = torch.full((nq, ef), -1, dtype=torch.int32)
    dists = torch.full((nq, ef), torch.inf)
    ids[:, 0], dists[:, 0] = entry, d0
    done = torch.zeros((nq, ef), dtype=torch.bool)
    n_exp = torch.zeros(nq, dtype=torch.int32)
    if filtered:
        ok = ((vwords[entry][None] & fwords) != 0).any(-1) & torch.isfinite(d0)
        res_ids, res_dists = torch.full_like(ids, -1), torch.full_like(dists, torch.inf)
        res_ids[:, 0] = torch.where(ok, entry, -1)
        res_dists[:, 0] = torch.where(ok, d0, torch.inf)
    if visited == "dense":
        seen = torch.zeros((nq, x.shape[0]), dtype=torch.uint8)
        seen[:, entry] = 1
        lookup = torch.full((nq, 1), -1, dtype=torch.int32)
    else:
        lookup = torch.full((nq, default_visited_cap(ef)), -1, dtype=torch.int32)
        _table_insert(lookup, torch.full((nq, 1), entry, dtype=torch.int32))
    steps = 0
    while steps < max_steps:
        frontier = (ids >= 0) & ~done
        if not bool(frontier.any()):
            break
        steps += 1
        fd = torch.where(frontier, dists, torch.inf)
        sel = fd.argmin(-1)
        active = torch.isfinite(fd[rows, sel])
        nbrs = graph_ids[ids[rows, sel].clamp_min(0).long()]
        done[rows, sel] = True
        nbrs = torch.where(active[:, None] & (nbrs >= 0), nbrs, -1)
        out = ops.search_expand(x, q, nbrs, lookup, valid, vwords, fwords)
        nbrs, dq, fresh = out[:3]
        if visited == "dense":
            idx = nbrs.clamp_min(0).long()
            fresh = fresh & ~seen.gather(1, idx).bool()
            seen.scatter_reduce_(1, idx, fresh.to(torch.uint8), reduce="amax")
        else:
            _table_insert(lookup, torch.where(fresh, nbrs, -1))
        dq = torch.where(fresh, dq, torch.inf)
        n_exp += fresh.sum(-1, dtype=torch.int32)
        ids, dists, done = ops.topr_merge(
            torch.cat([ids, torch.where(fresh, nbrs, -1)], -1), torch.cat([dists, dq], -1), ef,
            flags=done,
        )
        if filtered:
            keep = fresh & out[3]
            res_ids, res_dists = ops.topr_merge(
                torch.cat([res_ids, torch.where(keep, nbrs, -1)], -1),
                torch.cat([res_dists, torch.where(keep, dq, torch.inf)], -1),
                ef,
            )
    if filtered:
        ids, dists = res_ids, res_dists
    return ids[:, :k], dists[:, :k], n_exp, steps


@pytest.mark.parametrize("case", ["dense", "hashed", "filtered", "dead-entry", "cut"])
def test_late_frontier_test_is_the_blocking_loop_plus_one_spare_step(graph, monkeypatch, case):
    """The loop that reads each frontier test one step late returns bitwise
    the loop that waits for each test, and launches exactly one more
    expansion, the spare step (`search/spare_steps`), or none where
    `max_steps` cuts the search before its frontier empties."""
    _, _, _, tx, tpool, tq = graph
    g = torch.Generator().manual_seed(7)
    entry = int(medoid(tx))
    k, ef, max_steps = 10, 48, 512
    kw = dict(visited="dense" if case == "dense" else "hashed")
    valid = vwords = fwords = None
    if case == "filtered":
        store = L.encode_labels(torch.randint(0, 4, (tx.shape[0],), generator=g), 4)
        kw.update(labels=store, filter=torch.randint(0, 4, (tq.shape[0],), generator=g))
        vwords, fwords = store.words, L.query_words(kw["filter"], store.w)
    if case == "dead-entry":
        valid = torch.rand(tx.shape[0], generator=g) > 0.1
        valid[entry] = False
        kw.update(valid=valid)
    if case == "cut":
        max_steps = 4
    calls = [0]
    inner = ops.search_expand

    def counted(*a):
        calls[0] += 1
        return inner(*a)

    monkeypatch.setattr(ops, "search_expand", counted)
    want = _blocking_search(tx, tpool.ids, tq, entry, k=k, ef=ef, max_steps=max_steps,
                            visited=kw["visited"], valid=valid, vwords=vwords, fwords=fwords)
    assert calls[0] == want[3] and (want[3] == max_steps) == (case == "cut")
    calls[0] = 0
    spare = trace.counts()["search/spare_steps"]
    got = search(tx, tpool.ids, tq, k=k, ef=ef, max_steps=max_steps, entry=entry, device="cpu",
                 **kw)
    spare = trace.counts()["search/spare_steps"] - spare
    assert spare == int(case != "cut") and calls[0] == want[3] + spare
    for a, b in zip(got, want[:3]):
        assert torch.equal(a, b)
    if case == "filtered":
        assert bool(L.allowed_mask(got.ids, fwords, vwords)[got.ids >= 0].all())


def test_search_rejects_what_is_not_ported(graph):
    _, _, _, tx, tpool, tq = graph
    # every option is ported; a filter without its label store still raises
    with pytest.raises(ValueError, match="label store"):
        search(tx, tpool.ids, tq, device="cpu", filter=np.zeros(tq.shape[0], np.int32))
    # valid=, rescore=, labels= alone and an identity ids_map change no id
    # and no distance: an all-live mask, a rescore against the fp32
    # traversal tier itself (the same distance formula on the CPU)
    plain = search(tx, tpool.ids, tq, device="cpu")
    live = torch.ones(tx.shape[0], dtype=torch.bool)
    ident = torch.arange(tx.shape[0], dtype=torch.int32)
    words = torch.zeros((tx.shape[0], 1), dtype=torch.int32)
    both = search(
        tx, tpool.ids, tq, device="cpu", valid=live, rescore=tx, labels=words, ids_map=ident
    )
    assert torch.equal(plain.ids, both.ids) and torch.equal(plain.dists, both.dists)
    with pytest.raises(ValueError):
        search(tx, tpool.ids, tq, k=10, ef=8, device="cpu")
    assert default_visited_cap(64) == j_default_visited_cap(64) == 512
    assert EF_CEILING == 512
