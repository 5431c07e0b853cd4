"""repro_torch.serve.ann_engine against repro.serve.ann_engine, and its
acceptance contract on the port.

  * the scheduler: one fake worker and one fake clock drive both packages'
    `AnnEngine` through the same script (mixed k / ef / filtered requests,
    saturation, mutations under the quantum): the logs, every field of
    `stats()`, the rejections, the results and every array the worker
    received are equal, exactly; each scheduler unit test of
    `tests/test_ann_engine.py` runs on both packages;
  * `synth_trace`: one `np.random.default_rng` seed gives identical events
    in both packages;
  * engine equals direct search, bitwise (ids and dists), on the port: fp32
    dense and hashed, int8 + fp32 rescore, int8 + the host tier, the layout
    pass's `ids_map`, with the reference's mixed filtered requests, against
    Q = 1 calls and against one batched call per (ef, filtered) group;
  * the port's engine against the JAX engine on the same operands
    (`convert.static_worker_from_jax`): every request's dists within rtol
    1e-5 of the reference's (fp32 sums in another order, the tolerance
    `tests/test_torch_search.py` states) and its ids equal, except at a
    rank whose two dists agree within that tolerance (an fp32 near-tie);
  * `DynamicWorker`: the engine's insert -> delete_oldest -> queries equals
    a twin port index given the same mutations, and a delete-only run from
    `convert.dynamic_worker_from_jax` leaves the JAX worker's live labels,
    exactly (deletes draw nothing);
  * `ShardedWorker` at S = 1, 2, 3, and the reference's S = 2 worker
    carried across by `convert.sharded_worker_from_jax`: bitwise the
    `StaticWorker`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grnnd as jgrnnd
from repro.core import labels as jlab
from repro.core import vecstore as jvecstore
from repro.core.dynamic import DynamicConfig as JDynamicConfig
from repro.core.dynamic import DynamicIndex as JDynamicIndex
from repro.core.pools import Pool as JPool
from repro.serve import ann_engine as JAE
from repro_torch import convert
from repro_torch.core import (
    DynamicConfig,
    DynamicIndex,
    HostTier,
    Pool,
    encode,
    encode_labels,
    medoid,
    optimize,
    predicate_fraction,
    search,
    shard,
)
from repro_torch.serve import ann_engine as AE

# the suite runs in parallel workers: one intra-op thread each keeps torch
# from oversubscribing the cores the JAX tests share
torch.set_num_threads(1)

N, D, NL = 192, 16, 16
CFG = jgrnnd.GRNNDConfig(s=8, r=16, t1=2, t2=3, pairs_per_vertex=16)
ENGINES = pytest.mark.parametrize("E", [JAE, AE], ids=["jax", "torch"])


# ---------------------------------------------------------------------------
# fakes
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FakeWorker:
    """Deterministic worker: ids encode the query's first component, so a
    request's result proves which row of which batch served it; each call
    advances the fake clock by `service` seconds and is recorded with
    copies of its arrays."""

    def __init__(self, clock, service=1.0):
        self.clock = clock
        self.service = service
        self.calls = []
        self.received = []

    def search_batch(self, q, *, k, ef, fwords=None):
        self.calls.append((q.shape, k, ef, None if fwords is None else fwords.shape))
        self.received.append(("search", q.copy(), k, ef, None if fwords is None else fwords.copy()))
        self.clock.advance(self.service)
        ids = q[:, 0].astype(np.int32)[:, None] + np.arange(k, dtype=np.int32)
        return ids, ids.astype(np.float32)

    def apply_mutation(self, mut):
        self.received.append(("mutation", mut.kind, mut.n_items, mut.vectors, mut.labels))
        self.clock.advance(self.service)


def fake_engine(E, **cfg_kw):
    clk = FakeClock()
    w = FakeWorker(clk)
    return E.AnnEngine(w, E.EngineConfig(**cfg_kw), clock=clk), w, clk


def vec(tag, d=4):
    v = np.zeros(d, np.float32)
    v[0] = tag
    return v


# ---------------------------------------------------------------------------
# the scheduler against the reference's, exactly
# ---------------------------------------------------------------------------


def _script(E):
    """One scripted run: mixed k / ef / filtered queries, mutations of
    every kind under the quantum, saturation, a stats reset. Returns the
    engine, its worker and every result taken, in order."""
    eng, w, clk = fake_engine(E, max_pending=6, max_batch=4, query_quantum=2, ef_menu=(32, 48))
    fw = np.array([5, 0], np.int32)
    taken, rids = [], []

    def submit(i, k, ef, filt):
        try:
            rids.append(eng.submit(vec(i), k=k, ef=ef, filter_words=fw if filt else None))
        except E.EngineSaturated:
            pass
        clk.advance(0.25)

    for i in range(9):  # past max_pending: the last three are shed
        submit(i, [5, 10][i % 2], [20, 40, 48][i % 3], i % 4 == 0)
    eng.submit_insert(np.ones((3, 4), np.float32), labels=np.arange(3))
    eng.submit_delete(np.arange(2))
    eng.submit_delete_oldest(4)
    eng.run(max_steps=3)
    for i in range(9, 14):
        submit(i, 5, [32, 100][i % 2], i % 2 == 1)
    eng.run()
    taken += [eng.take_result(r) for r in rids]
    first = (list(eng.log), eng.stats())
    eng.reset_stats()
    rids.clear()
    for i in range(14, 20):
        submit(i, 10, 48, False)
        eng.step()
    eng.run()
    taken += [eng.take_result(r) for r in rids]
    return eng, w, taken, first


def test_scheduler_equals_the_reference_exactly():
    (j_eng, j_w, j_taken, j_first), (t_eng, t_w, t_taken, t_first) = _script(JAE), _script(AE)
    assert t_first[0] == j_first[0] and t_eng.log == j_eng.log
    assert t_first[1]._asdict() == j_first[1]._asdict()
    assert t_eng.stats()._asdict() == j_eng.stats()._asdict()
    assert j_first[1].n_rejected == 4 and j_first[1].n_mutations == 9
    assert len(t_taken) == len(j_taken) == 16
    for a, b in zip(t_taken, j_taken):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)
        assert (a.t_submit, a.t_done) == (b.t_submit, b.t_done)
    assert t_w.calls == j_w.calls
    assert len(t_w.received) == len(j_w.received)
    for a, b in zip(t_w.received, j_w.received):
        assert len(a) == len(b) and a[0] == b[0]
        for u, v in zip(a[1:], b[1:]):
            if isinstance(u, np.ndarray) or isinstance(v, np.ndarray):
                np.testing.assert_array_equal(u, v)
                assert u.dtype == v.dtype
            else:
                assert u == v


# ---------------------------------------------------------------------------
# the reference's scheduler units, on both packages
# ---------------------------------------------------------------------------


@ENGINES
def test_bucket_rounding(E):
    assert [E.bucket_q(n) for n in (1, 2, 3, 4, 5, 8, 9)] == [1, 2, 4, 4, 8, 8, 16]


@ENGINES
def test_bucket_selection_pads_to_pow2(E):
    eng, w, _ = fake_engine(E, max_batch=8, ef_menu=(48,))
    for i in range(5):
        eng.submit(vec(i), k=5, ef=48)
    eng.run()
    assert w.calls == [((8, 4), 16, 48, None)]
    assert eng.log == [("query", (8, 48, False), 5)]
    assert eng.stats().mean_occupancy == pytest.approx(5 / 8)
    for i in range(5):
        assert eng.take_result(i).ids[0] == i
    # the pad rows repeat the last real request
    np.testing.assert_array_equal(w.received[0][1][5:], np.stack([vec(4)] * 3))


@ENGINES
def test_grouping_by_ef_preserves_fifo_within_group(E):
    eng, _, _ = fake_engine(E, max_batch=8, ef_menu=(32, 48))
    for i, ef in enumerate([32, 48, 32, 48, 48]):
        eng.submit(vec(i), k=5, ef=ef)
    eng.run()
    assert eng.log == [("query", (2, 32, False), 2), ("query", (4, 48, False), 3)]
    for i in range(5):
        assert eng.take_result(i).ids[0] == i


@ENGINES
def test_filtered_and_unfiltered_never_share_a_batch(E):
    eng, w, _ = fake_engine(E, max_batch=8, ef_menu=(48,))
    fw = np.ones(1, np.int32)
    eng.submit(vec(0), k=5, ef=48)
    eng.submit(vec(1), k=5, ef=48, filter_words=fw)
    eng.submit(vec(2), k=5, ef=48)
    eng.run()
    assert [e[1] for e in eng.log] == [(2, 48, False), (1, 48, True)]
    assert w.calls[0][3] is None and w.calls[1][3] == (1, 1)


@ENGINES
def test_admission_rejects_past_max_pending(E):
    eng, _, _ = fake_engine(E, max_pending=4, max_batch=4, ef_menu=(48,))
    for i in range(4):
        eng.submit(vec(i), k=5, ef=48)
    with pytest.raises(E.EngineSaturated):
        eng.submit(vec(9), k=5, ef=48)
    assert eng.stats().n_rejected == 1
    eng.run()
    eng.submit(vec(5), k=5, ef=48)
    assert eng.pending_queries == 1


@ENGINES
def test_mutation_interleave_quantum(E):
    eng, _, _ = fake_engine(E, max_batch=1, query_quantum=2, ef_menu=(48,))
    for i in range(5):
        eng.submit(vec(i), k=5, ef=48)
    eng.submit_insert(np.zeros((3, 4), np.float32))
    eng.submit_delete(np.arange(2))
    eng.run()
    assert [e[0] for e in eng.log] == [
        "query", "query", "mutation", "query", "query", "mutation", "query",
    ]
    assert eng.stats().n_mutations == 5


@ENGINES
def test_mutations_run_immediately_on_idle_queue(E):
    eng, _, _ = fake_engine(E, query_quantum=4, ef_menu=(48,))
    eng.submit_insert(np.zeros((2, 4), np.float32))
    assert eng.step() and eng.log == [("mutation", "insert", 2)]


@ENGINES
def test_percentile_nearest_rank(E):
    assert E.percentile([1, 2, 3, 4], 50) == 2
    assert E.percentile([1, 2, 3, 4], 99) == 4
    assert E.percentile([7], 50) == 7
    assert E.percentile([], 99) == 0.0


@ENGINES
def test_stats_on_hand_computed_trace(E):
    # submits at t = 0, 1, 2, 3, service 1 s, one request a batch:
    # completions at t = 5, 6, 7, 8 -> latencies all 5 s; window 8 s
    eng, _, clk = fake_engine(E, max_batch=1, ef_menu=(48,))
    for i in range(4):
        eng.submit(vec(i), k=5, ef=48)
        clk.advance(1.0)
    eng.run()
    s = eng.stats()
    assert s.n_completed == 4
    assert [eng.take_result(i).latency for i in range(4)] == [5.0, 5.0, 5.0, 5.0]
    assert s.p50_ms == pytest.approx(5000.0) and s.p99_ms == pytest.approx(5000.0)
    assert s.qps == pytest.approx(4 / 8.0)
    assert s.mean_occupancy == 1.0
    assert s.n_buckets == 1 and s.bucket_runs == {(1, 48, False): 4}


@ENGINES
def test_ef_normalization(E):
    cfg = E.EngineConfig(ef_menu=(32, 64), overfetch=4)
    assert E.normalize_ef(cfg, 10, 20, False) == 32
    assert E.normalize_ef(cfg, 10, 20, True) == 64
    assert E.normalize_ef(cfg, 10, 200, False) == 200
    assert E.normalize_ef(E.EngineConfig(ef_menu=()), 10, 20, False) == 20


@ENGINES
def test_reset_stats_keeps_bucket_set(E):
    eng, _, _ = fake_engine(E, max_batch=4, ef_menu=(48,))
    eng.submit(vec(0), k=5, ef=48)
    eng.run()
    eng.reset_stats()
    s = eng.stats()
    assert s.n_completed == 0 and s.bucket_runs == {}
    assert s.n_buckets == 1


@ENGINES
def test_synth_trace_deterministic_and_interleaved(E):
    q = np.zeros((6, 4), np.float32)
    churn = np.zeros((2, 3, 4), np.float32)
    kw = dict(offered_qps=100.0, k_choices=(5, 10), ef_choices=(32, 48))
    tr1 = E.synth_trace(np.random.default_rng(7), q, mutation_every=3, churn_vectors=churn, **kw)
    tr2 = E.synth_trace(np.random.default_rng(7), q, mutation_every=3, churn_vectors=churn, **kw)
    assert [e.kind for e in tr1] == ["query"] * 3 + ["insert", "delete_oldest"] + [
        "query"
    ] * 3 + ["insert", "delete_oldest"]
    assert [e.t for e in tr1] == [e.t for e in tr2]
    assert all(a <= b for a, b in zip([e.t for e in tr1], [e.t for e in tr1][1:]))


@pytest.mark.parametrize("churn", [False, True], ids=["plain", "churn"])
@pytest.mark.parametrize("filtered", [False, True], ids=["nofilter", "fwords"])
def test_synth_trace_equals_the_reference(churn, filtered):
    rng = np.random.default_rng(11)
    q = rng.normal(size=(20, 4)).astype(np.float32)
    fw = rng.integers(0, 2**31 - 1, (20, 2)).astype(np.int32)
    fwords = [fw[i] if i % 2 == 0 else None for i in range(20)] if filtered else None
    kw = dict(offered_qps=250.0, k_choices=(5, 10), ef_choices=(32, 48, 64), fwords=fwords)
    if churn:
        kw.update(mutation_every=6, churn_vectors=[q[:3], q[3:7]],
                  churn_labels=[np.arange(3), np.arange(4)])
    want = JAE.synth_trace(np.random.default_rng(3), q, **kw)
    got = AE.synth_trace(np.random.default_rng(3), q, **kw)
    assert len(got) == len(want) == (26 if churn else 20)
    for a, b in zip(got, want):
        for f in dataclasses.fields(b):
            u, v = getattr(a, f.name), getattr(b, f.name)
            if isinstance(v, np.ndarray) or isinstance(u, np.ndarray):
                np.testing.assert_array_equal(u, v)
            else:
                assert u == v, f.name


# ---------------------------------------------------------------------------
# the engine on the port's search: bitwise direct search
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built():
    """The reference's graph over seeded normal rows, its labels, and the
    mixed request specs of `tests/test_ann_engine.py` (10 requests)."""
    x = jax.random.normal(jax.random.PRNGKey(0), (N, D), jnp.float32)
    pool = jgrnnd.build_graph(jax.random.PRNGKey(1), x, CFG)
    vlab = jax.random.randint(jax.random.PRNGKey(5), (N,), 0, NL)
    q = np.array(jax.random.normal(jax.random.PRNGKey(2), (10, D), jnp.float32))
    fw = np.array(jlab.random_query_filters(jax.random.PRNGKey(3), 10, NL, 0.4))
    # admission leaves these efs as they are (ef >= 4k, on the menu), and
    # the (32, unfiltered) group has 5 members: an 8-row bucket, 3 pads
    specs = [([5, 10][i % 2], [32, 48][(i // 2) % 2], i % 3 == 0) for i in range(10)]
    return dict(
        jx=x, jpool=pool, jlabels=jlab.encode_labels(vlab, NL),
        x=np.array(x), ids=np.array(pool.ids), dists=np.array(pool.dists),
        vlab=np.array(vlab), q=q, fw=fw, specs=specs,
    )


def _operands(b, case):
    """Port search operands of one serving configuration, on the CPU."""
    x = torch.from_numpy(b["x"])
    ids = torch.from_numpy(b["ids"])
    labels = encode_labels(torch.from_numpy(b["vlab"]), NL)
    kw = dict(visited="dense", visited_cap=None, rescore=None, ids_map=None)
    xt = x
    if case == "fp32-hashed":
        kw.update(visited="hashed", visited_cap=4 * N)
    elif case == "int8-rescore":
        xt, kw["rescore"] = encode(x, "int8"), x
    elif case == "int8-host":
        xt, kw["rescore"] = encode(x, "int8"), HostTier(x)
    entry = medoid(xt)
    words = labels.words
    if case == "layout":
        opt = optimize(xt, ids, order="bfs", labels=labels, device="cpu")
        xt, ids, entry, words, kw["ids_map"] = opt.x, opt.graph_ids, opt.entry, opt.vwords, opt.inv
    return dict(x=xt, graph_ids=ids, entry=entry, labels=words, **kw), labels


def _direct(ops, q, fw, k, ef):
    kw = dict(ops)
    x, g, labels = kw.pop("x"), kw.pop("graph_ids"), kw.pop("labels")
    return search(x, g, torch.from_numpy(q), k=k, ef=ef, labels=labels if fw is not None else None,
                  filter=None if fw is None else torch.from_numpy(fw), device="cpu", **kw)


def _engine_results(worker, b, cfg):
    eng = AE.AnnEngine(worker, cfg)
    rids = [
        eng.submit(b["q"][i], k=k, ef=ef, filter_words=b["fw"][i] if filt else None)
        for i, (k, ef, filt) in enumerate(b["specs"])
    ]
    eng.run()
    return eng, [eng.take_result(r) for r in rids]


CASES = ("fp32-dense", "fp32-hashed", "int8-rescore", "int8-host", "layout")


@pytest.mark.parametrize("case", CASES)
def test_engine_is_bitwise_direct_search(built, case):
    ops, labels = _operands(built, case)
    kw = {k: v for k, v in ops.items() if k not in ("x", "graph_ids")}
    worker = AE.StaticWorker(ops["x"], ops["graph_ids"], device="cpu", **kw)
    eng, got = _engine_results(worker, built, AE.EngineConfig(ef_menu=(32, 48), max_batch=8))
    assert any(key[0] > n_real for (_, key, n_real) in eng.log)  # padding ran
    q, fw, specs = built["q"], built["fw"], built["specs"]
    for i, (k, ef, filt) in enumerate(specs):
        one = _direct(ops, q[i : i + 1], fw[i : i + 1] if filt else None, k, ef)
        np.testing.assert_array_equal(got[i].ids, one.ids.numpy()[0])
        np.testing.assert_array_equal(got[i].dists, one.dists.numpy()[0])
        if filt:
            assert predicate_fraction(one.ids, torch.from_numpy(fw[i : i + 1]), labels.words) == 1.0
    # one batched call per (ef, filtered) group at the engine's k_exec
    for ef in (32, 48):
        for filt in (False, True):
            rows = [i for i, s in enumerate(specs) if s[1:] == (ef, filt)]
            if not rows:
                continue
            batch = _direct(ops, q[rows], fw[rows] if filt else None, min(16, ef), ef)
            for j, i in enumerate(rows):
                k = specs[i][0]
                np.testing.assert_array_equal(got[i].ids, batch.ids.numpy()[j, :k])
                np.testing.assert_array_equal(got[i].dists, batch.dists.numpy()[j, :k])


def test_engine_equals_one_direct_batched_call(built):
    """The other grouping extreme: 9 requests in buckets of 4 + 4 + 1 equal
    one direct Q = 9 call (the reference's Q-composition test)."""
    x, ids, q = (torch.from_numpy(built[k]) for k in ("x", "ids", "q"))
    entry = medoid(x)
    eng = AE.AnnEngine(AE.StaticWorker(x, ids, entry=entry, device="cpu"),
                       AE.EngineConfig(ef_menu=(48,), max_batch=4))
    rids = [eng.submit(built["q"][i], k=10, ef=48) for i in range(9)]
    eng.run()
    assert [e[1][0] for e in eng.log] == [4, 4, 1]
    direct = search(x, ids, q[:9], k=10, ef=48, entry=entry, device="cpu")
    for i, rid in enumerate(rids):
        res = eng.take_result(rid)
        np.testing.assert_array_equal(res.ids, direct.ids.numpy()[i])
        np.testing.assert_array_equal(res.dists, direct.dists.numpy()[i])


@pytest.mark.parametrize("case", ["fp32-dense", "fp32-hashed", "int8-rescore", "int8-host"])
def test_engine_matches_the_jax_engine(built, case):
    """The same operands in both engines: the reference's worker carried
    across by `convert.static_worker_from_jax`."""
    jx, jpool = built["jx"], built["jpool"]
    xt, rescore, visited, cap = jx, None, "dense", None
    if case == "fp32-hashed":
        visited, cap = "hashed", 4 * N
    elif case.startswith("int8"):
        xt, rescore = jvecstore.encode(jx, "int8"), jx
        if case == "int8-host":
            rescore = jvecstore.HostTier(jx)
    jworker = JAE.StaticWorker(xt, jpool.ids, visited=visited, visited_cap=cap, rescore=rescore,
                               labels=built["jlabels"])
    worker = convert.static_worker_from_jax(jworker, device="cpu")
    assert int(worker.entry) == int(jworker.entry)
    assert isinstance(worker.rescore, HostTier) == (case == "int8-host")
    cfg = dict(ef_menu=(32, 48), max_batch=8)
    j_eng = JAE.AnnEngine(jworker, JAE.EngineConfig(**cfg))
    j_rids = [
        j_eng.submit(built["q"][i], k=k, ef=ef, filter_words=built["fw"][i] if filt else None)
        for i, (k, ef, filt) in enumerate(built["specs"])
    ]
    j_eng.run()
    want = [j_eng.take_result(r) for r in j_rids]
    t_eng, got = _engine_results(worker, built, AE.EngineConfig(**cfg))
    assert t_eng.log == j_eng.log
    for a, b in zip(got, want):
        want_d = np.asarray(b.dists)
        np.testing.assert_allclose(a.dists, want_d, rtol=1e-5)
        # ids may differ only at a near-tie: a rank whose dist agrees within
        # rtol with a neighbouring rank's, or the last (tied, maybe, with
        # the first candidate left out)
        eq = np.isclose(want_d[1:], want_d[:-1], rtol=1e-5)
        tie = np.r_[eq, True] | np.r_[False, eq]
        assert ((a.ids == b.ids) | tie).all(), (a.ids, b.ids)


# ---------------------------------------------------------------------------
# the dynamic and sharded workers
# ---------------------------------------------------------------------------


def test_dynamic_engine_matches_twin_index(built):
    """Engine-scheduled insert -> delete_oldest -> queries equals a twin
    index given the same mutations directly (label space)."""
    cfg = DynamicConfig(refine_rounds=1)
    pool = Pool(torch.from_numpy(built["ids"]), torch.from_numpy(built["dists"]))

    def make():
        return DynamicIndex(torch.from_numpy(built["x"]), pool, cfg, device="cpu")

    idx_eng, idx_ref = make(), make()
    xs = np.random.default_rng(9).normal(size=(8, D)).astype(np.float32)
    eng = AE.AnnEngine(AE.DynamicWorker(idx_eng), AE.EngineConfig(ef_menu=(48,), max_batch=8))
    eng.submit_insert(xs)
    eng.submit_delete_oldest(4)
    eng.run()  # mutations run first (empty query queue)
    rids = [eng.submit(built["q"][i], k=10, ef=48) for i in range(9)]
    eng.run()

    idx_ref.insert(torch.from_numpy(xs))
    idx_ref.delete(idx_ref.oldest_live(4))
    direct = idx_ref.search(torch.from_numpy(built["q"][:9]), k=10, ef=48, overfetch=1)
    for i, rid in enumerate(rids):
        res = eng.take_result(rid)
        np.testing.assert_array_equal(res.ids, direct.ids.numpy()[i])
        np.testing.assert_array_equal(res.dists, direct.dists.numpy()[i])
    assert not np.isin(direct.ids.numpy(), np.arange(4)).any()  # the 4 oldest are gone
    assert eng.stats().n_mutations == 12


def test_oldest_live_is_the_smallest_live_labels_after_a_layout_pass(built):
    """`DynamicIndex.oldest_live`, the delete-oldest rule of the worker, the
    CLI's churn and the twin checks: the smallest live labels, ascending,
    also where a layout pass has put the slots out of label order."""
    pool = Pool(torch.from_numpy(built["ids"]), torch.from_numpy(built["dists"]))
    idx = DynamicIndex(torch.from_numpy(built["x"]), pool,
                       DynamicConfig(refine_rounds=1, layout="bfs"), device="cpu")
    slots = idx.labels[: idx.size]
    assert not torch.equal(slots, torch.sort(slots).values)  # slots out of label order
    idx.delete(np.array([0, 3, 5]))
    assert idx.oldest_live(6).tolist() == [1, 2, 4, 6, 7, 8]
    live = np.sort(idx.labels[: idx.size][idx.valid[: idx.size]].numpy())
    assert np.array_equal(idx.oldest_live(N).numpy(), live) and len(live) == N - 3


def test_dynamic_worker_deletes_equal_the_reference(built):
    """delete_oldest and delete from the reference's worker state leave its
    live labels, exactly, and the port's searches keep returning live ones."""
    jidx = JDynamicIndex(built["jx"], JPool(built["jpool"].ids, built["jpool"].dists),
                         JDynamicConfig(refine_rounds=1),
                         vertex_labels=built["vlab"], n_labels=NL)
    jworker = JAE.DynamicWorker(jidx, visited="hashed")
    worker = convert.dynamic_worker_from_jax(jworker, cfg=DynamicConfig(refine_rounds=1),
                                             device="cpu")
    assert worker.visited == "hashed" and worker.index.n_labels == NL
    muts = [
        JAE.MutationRequest(kind="delete_oldest", n_items=7),
        JAE.MutationRequest(kind="delete", n_items=3, labels=np.array([50, 7, 121])),
        JAE.MutationRequest(kind="delete_oldest", n_items=5),
    ]
    for m in muts:
        jworker.apply_mutation(m)
        worker.apply_mutation(AE.MutationRequest(**dataclasses.asdict(m)))
        live_j = np.sort(jidx.labels[: jidx.size][np.asarray(jidx.valid[: jidx.size])])
        idx = worker.index
        live_t = np.sort(idx.labels[: idx.size][idx.valid[: idx.size]].numpy())
        np.testing.assert_array_equal(live_t, live_j)
    assert worker.index.n_live == jidx.n_live == N - 15
    ids, _ = worker.search_batch(built["q"], k=10, ef=48)
    assert np.isin(ids, live_t).all()
    fw = built["fw"][:4]
    ids, _ = worker.search_batch(built["q"][:4], k=5, ef=48, fwords=fw)
    allowed = (jlab.pack_ids(jnp.asarray(built["vlab"]), NL)[ids] & fw[:, None, :]).any(-1)
    assert np.asarray(allowed)[ids >= 0].all()


@pytest.mark.parametrize("s", [1, 2, 3])
def test_sharded_worker_is_bitwise_the_static_worker(built, s):
    x, ids = torch.from_numpy(built["x"]), torch.from_numpy(built["ids"])
    labels = encode_labels(torch.from_numpy(built["vlab"]), NL)
    entry = medoid(x)
    static = AE.StaticWorker(x, ids, entry=entry, visited="hashed", labels=labels, device="cpu")
    sharded = AE.ShardedWorker(shard(x, ids, s, labels=labels, entry=entry, device="cpu"),
                               visited="hashed")
    cfg = AE.EngineConfig(ef_menu=(32, 48), max_batch=8)
    _, want = _engine_results(static, built, cfg)
    _, got = _engine_results(sharded, built, cfg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)


def test_sharded_worker_from_jax(built):
    """The reference's S = 2 sharded worker carried across: bitwise the
    port's static worker from the same entry."""
    from repro.core import corpus_shard as JCS

    jidx = JCS.shard(built["jx"], built["jpool"].ids, 2, labels=built["jlabels"])
    worker = convert.sharded_worker_from_jax(JAE.ShardedWorker(jidx, visited="hashed"),
                                             device="cpu")
    assert worker.index.n_shards == 2 and worker.visited == "hashed"
    x, ids = torch.from_numpy(built["x"]), torch.from_numpy(built["ids"])
    labels = encode_labels(torch.from_numpy(built["vlab"]), NL)
    static = AE.StaticWorker(x, ids, entry=int(jidx.entry), visited="hashed", labels=labels,
                             device="cpu")
    cfg = AE.EngineConfig(ef_menu=(32, 48), max_batch=8)
    _, want = _engine_results(static, built, cfg)
    _, got = _engine_results(worker, built, cfg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)
