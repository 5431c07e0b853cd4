"""The port's kNN-LM retrieval and LM serving engine, on the CPU.

Against the JAX package (inputs from numpy seeds, state carried across with
`convert`):

  * `vote_log_probs` and `fuse`: log-probs within rtol 1e-5 / atol 1e-5 of
    the reference's, the same ``-inf`` support, mass 1 at vocab 262,144,
    the no-support fallback to the pure LM;
  * `knn_logits` on a converted array-backed store, and `knn_log_probs` on a
    converted `DynamicDatastore`: ids equal but at distance near-ties (the
    two sum fp32 distances in other orders), log-probs within 1e-4;
  * `ServeEngine.generate` at reduced gemma3-1b, greedy, fp32: tokens equal
    the reference engine's without hooks and with a logit hook over a frozen
    converted `KNNDatastore`, and, with `eos_id`, tokens and `final_pos`
    equal the reference's; the same hook in reduced deepseek-moe-16b's (MoE)
    decode loop.

Port against port, the reference suite's `DynamicDatastore` cases: fp32
retrieval bitwise the array-backed path pinned to the same entry and
validity view (dense and hashed visited sets); int8 traversal + fp32
rescore within 1pt of fp32's memorization accuracy; the host tier bitwise
the device tier; the engine-routed search bitwise the direct one; streaming
inserts from an empty datastore retrievable; the source filter respecting
provenance; an empty labeled datastore bootstrapping; the hook contract
through `generate` (two-argument logit hook, the stream hook growing the
datastore, `return_hidden`); seeded temperature sampling repeating and
keeping to the tokens of nonzero probability; and `distance_excess`, the
retrieval measure phase 4i of `chip_smoke.py` holds the kernels to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core import grnnd as jgrnnd
from repro.core.search import search as jsearch
from repro.models import transformer as JT
from repro.retrieval import knn_lm as jknn
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.core import (
    Draws,
    DynamicConfig,
    GRNNDConfig,
    brute_force_knn,
    build_graph,
    distance_excess,
    pool_excess,
    search,
)
from repro_torch.retrieval import knn_lm
from repro_torch.retrieval.knn_lm import DynamicDatastore
from repro_torch.serve import ServeEngine
from _torch_lm import make_model

torch.set_num_threads(1)

N, DIM, VOCAB = 240, 32, 128
K, EF = 8, 32
CFG = GRNNDConfig(s=8, r=16, t1=2, t2=3, pairs_per_vertex=16)
CPU = "cpu"


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, DIM)).astype(np.float32)
    return x, rng.integers(0, VOCAB, N).astype(np.int32)


def _dyn(pairs, **kw):
    x, toks = pairs
    return DynamicDatastore.build(
        x, toks, VOCAB, build_cfg=CFG, draws=Draws(2, CPU), device=CPU, k=K, ef=EF, **kw
    )


@pytest.fixture(scope="module")
def fp32_ds(pairs):
    return _dyn(pairs, precision="fp32")


@pytest.fixture(scope="module")
def int8_ds(pairs):
    return _dyn(pairs, precision="int8")


def _acc(klp, toks) -> float:
    return float((klp.argmax(-1) == torch.as_tensor(toks).long()).float().mean())


# -- the vote and the fusion against the reference ---------------------------


def test_vote_and_fuse_match_the_reference():
    rng = np.random.default_rng(1)
    q, k, vocab = 64, 8, 40  # a small vocab: many rows hold repeated tokens
    ids = rng.integers(-1, 100, (q, k)).astype(np.int32)
    ids[5] = -1  # a row with no valid slot
    dists = (rng.random((q, k)) * 30).astype(np.float32)
    toks = rng.integers(0, vocab, (q, k)).astype(np.int32)
    got = knn_lm.vote_log_probs(*map(torch.from_numpy, (ids, dists, toks)), vocab)
    want = np.asarray(jknn.vote_log_probs(*map(jnp.asarray, (ids, dists, toks)), vocab))
    assert np.array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert bool(torch.isneginf(got[5]).all())
    lm = rng.standard_normal((q, vocab)).astype(np.float32)
    fused = knn_lm.fuse(torch.from_numpy(lm), got, 0.3)
    jfused = np.asarray(jknn.fuse(jnp.asarray(lm), jnp.asarray(want), 0.3))
    np.testing.assert_allclose(fused.numpy(), jfused, rtol=1e-5, atol=1e-5)
    # the no-support row is the pure LM, exactly
    assert torch.equal(fused[5], torch.log_softmax(torch.from_numpy(lm), -1)[5])


def test_vote_sums_equal_tokens_in_slot_order():
    """Each token's weight is its slots' weights summed in slot order, the
    same value on every duplicate, so the write is order-free."""
    ids = torch.tensor([[0, 1, 2, 3, -1]])
    dists = torch.tensor([[0.5, 1.0, 2.0, 0.25, 9.0]])
    toks = torch.tensor([[7, 3, 7, 7, 3]], dtype=torch.int32)
    w = torch.softmax(-dists / 10.0, -1)
    got = knn_lm.vote_log_probs(ids, dists, toks, 11)
    p7 = ((0.0 + w[0, 0]) + w[0, 2]) + w[0, 3]
    lse = torch.logsumexp(torch.log(torch.stack([w[0, 1], p7])), 0)
    assert got[0, 7] == torch.log(p7) - lse and got[0, 3] == torch.log(w[0, 1]) - lse
    assert int(torch.isfinite(got).sum()) == 2


def test_fuse_preserves_mass_at_gemma3_vocab():
    vocab = 262_144
    lm = torch.randn((2, vocab), generator=torch.Generator().manual_seed(7))
    klp = torch.full((2, vocab), -torch.inf)
    klp[:, :3] = float(np.log(1 / 3))
    mass = torch.logsumexp(knn_lm.fuse(lm, klp, 0.3), -1).exp()
    np.testing.assert_allclose(mass.numpy(), 1.0, rtol=1e-5)


# -- retrieval against the reference -----------------------------------------


def _same_but_ties(got_ids, want_ids, got_d, want_d):
    """Rows with equal ids, except where the reference's distances hold a
    near-tie (the two sides order fp32 distances within an ulp)."""
    got_ids, want_ids = np.asarray(got_ids), np.asarray(want_ids)
    want_d = np.asarray(want_d)
    gaps = np.diff(np.sort(want_d, axis=1), axis=1)
    tie = (gaps <= 1e-4 * np.abs(want_d[:, 1:]) + 1e-5).any(1)
    bad = (got_ids != want_ids).any(1) & ~tie
    assert not bad.any(), f"{int(bad.sum())} rows differ away from a near-tie"
    same = ~(got_ids != want_ids).any(1)
    np.testing.assert_allclose(np.asarray(got_d)[same], want_d[same], rtol=1e-4, atol=1e-4)
    return same


def test_knn_logits_on_a_converted_store_match_the_reference(pairs):
    x, toks = pairs
    jstore = jknn.build_datastore(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(toks),
                                  jgrnnd.GRNNDConfig(**CFG._asdict()))
    store = convert.knn_datastore_from_jax(jstore, device=CPU)
    q = x[:64] + 0.05
    want = np.asarray(jknn.knn_logits(jstore, jnp.asarray(q), VOCAB, k=K, ef=EF))
    got = knn_lm.knn_logits(store, q, VOCAB, k=K, ef=EF)
    jres = jsearch(jstore.keys, jstore.graph, jnp.asarray(q), k=K, ef=EF)
    res = search(store.keys, store.graph, q, k=K, ef=EF, device=CPU)
    same = _same_but_ties(res.ids, jres.ids, res.dists, jres.dists)
    np.testing.assert_allclose(got.numpy()[same], want[same], rtol=1e-4, atol=1e-4)
    assert np.array_equal(np.isneginf(got.numpy()[same]), np.isneginf(want[same]))


def test_converted_dynamic_datastore_matches_the_reference(pairs):
    x, toks = pairs
    jds = jknn.DynamicDatastore.build(
        jax.random.PRNGKey(2), jnp.asarray(x), toks, VOCAB,
        build_cfg=jgrnnd.GRNNDConfig(**CFG._asdict()), precision="int8", k=K, ef=EF,
    )
    cfg = DynamicConfig(**jds.index.cfg._asdict())
    ds = convert.dynamic_datastore_from_jax(jds, cfg=cfg, device=CPU)
    assert len(ds) == len(jds) and ds.values.shape == (N,)
    q = x[:48] + 0.05
    jres = jds.index.search(jnp.asarray(q), k=K, ef=EF)
    res = ds.index.search(q, k=K, ef=EF)
    same = _same_but_ties(res.ids, jres.ids, res.dists, jres.dists)
    want = np.asarray(jds.knn_log_probs(jnp.asarray(q)))
    np.testing.assert_allclose(ds.knn_log_probs(q).numpy()[same], want[same], rtol=1e-4,
                               atol=1e-4)


# -- DynamicDatastore, port against port -------------------------------------


@pytest.mark.parametrize("visited", ["dense", "hashed"])
def test_fp32_dynamic_matches_the_array_path_bitwise(pairs, fp32_ds, visited):
    """Same graph + the same traversal pins -> bitwise-equal vote output."""
    x, toks = pairs
    store = knn_lm.build_datastore(x, toks, CFG, draws=Draws(2, CPU), device=CPU)
    assert torch.equal(store.graph, fp32_ds.index.pool.ids[:N])
    q = x[:64] + 0.05
    ds = DynamicDatastore(fp32_ds.index, fp32_ds.values, VOCAB, k=K, ef=EF, visited=visited)
    got = ds.knn_log_probs(q)
    want = knn_lm.knn_logits(store, q, VOCAB, k=K, ef=EF, entry=ds.index.entry(),
                             valid=ds.index.valid[:N], visited=visited)
    assert torch.equal(got, want)


def test_int8_rescore_keeps_memorization_accuracy(pairs, fp32_ds, int8_ds):
    x, toks = pairs
    ref = _acc(fp32_ds.knn_log_probs(x), toks)
    assert ref >= 0.9, f"fp32 memorization accuracy only {ref}"
    assert _acc(int8_ds.knn_log_probs(x), toks) >= ref - 0.01


def test_host_tier_is_bitwise_equal_to_device(pairs, int8_ds):
    x, _ = pairs
    host = _dyn(pairs, precision="int8", tier="host")
    assert torch.equal(host.knn_log_probs(x[:32]), int8_ds.knn_log_probs(x[:32]))


@pytest.mark.parametrize("visited", ["dense", "hashed"])
def test_engine_routed_search_is_bitwise_equal(pairs, visited):
    x, _ = pairs
    ds = _dyn(pairs, precision="int8", visited=visited)
    direct = ds.knn_log_probs(x[:16])
    engine = ds.attach_engine()
    routed = ds.knn_log_probs(x[:16])
    assert torch.equal(routed, direct)
    assert engine.stats().n_completed == 16


def test_streaming_inserts_retrieve_earlier_tokens():
    ds = DynamicDatastore.empty(DIM, VOCAB, precision="fp32", k=4, ef=32, device=CPU)
    assert len(ds) == 0
    assert bool(torch.isneginf(ds.knn_log_probs(torch.zeros((3, DIM)))).all())
    stream = knn_lm.make_stream_hook(ds, insert_every=2)
    rng = np.random.default_rng(5)
    hs, ts = [], []
    for _ in range(6):
        h = rng.standard_normal((8, DIM)).astype(np.float32)
        t = rng.integers(0, VOCAB, 8).astype(np.int32)
        stream(torch.from_numpy(h), torch.from_numpy(t))
        hs.append(h)
        ts.append(t)
    stream.flush()
    assert len(ds) == 48 and ds.values.shape == (48,)
    # the first step's pairs, written while the graph bootstrapped
    assert _acc(ds.knn_log_probs(hs[0]), ts[0]) >= 0.9


def test_source_filtered_retrieval_respects_provenance(pairs):
    x, _ = pairs
    half = N // 2
    toks = np.concatenate([np.random.default_rng(0).integers(0, 50, half),
                           np.random.default_rng(1).integers(50, 100, N - half)]).astype(np.int32)
    sources = (np.arange(N) >= half).astype(np.int32)
    ds = DynamicDatastore.build(x, toks, VOCAB, build_cfg=CFG, draws=Draws(2, CPU), device=CPU,
                                precision="fp32", sources=sources, n_sources=2, k=K, ef=EF)
    q = x[half - 8 : half + 8]  # straddle the source boundary
    for src, lo, hi in ((0, 0, 50), (1, 50, 100)):
        klp = ds.knn_log_probs(q, filter=torch.full((16,), src, dtype=torch.int32))
        support = torch.isfinite(klp)
        assert bool(support.any()), "filtered search lost all support"
        voted = torch.nonzero(support.any(0))[:, 0]
        assert int(voted.min()) >= lo and int(voted.max()) < hi


def test_empty_labeled_datastore_bootstraps():
    ds = DynamicDatastore.empty(DIM, VOCAB, precision="fp32", n_sources=2, device=CPU)
    h = np.random.default_rng(6).standard_normal((16, DIM)).astype(np.float32)
    ds.add(h, np.arange(16, dtype=np.int32), sources=np.repeat(np.arange(2, dtype=np.int32), 8))
    klp = ds.knn_log_probs(h[:8], filter=torch.zeros((8,), dtype=torch.int32))
    voted = torch.nonzero(torch.isfinite(klp).any(0))[:, 0]
    assert int(voted.max()) < 8  # source 0 holds tokens 0..7 only


# -- the serving engine -------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    jcfg, cfg = jreduced(jget_arch("gemma3-1b")), reduced(get_arch("gemma3-1b"))
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device=CPU)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    return cfg, params, jcfg, jparams, tokens


def _generate_with_and_without_a_hook(lm):
    cfg, params, jcfg, jparams, tokens = lm
    rng = np.random.default_rng(3)
    keys = rng.standard_normal((N, cfg.d_model)).astype(np.float32)
    vals = rng.integers(0, cfg.vocab, N).astype(np.int32)
    jstore = jknn.build_datastore(jax.random.PRNGKey(2), jnp.asarray(keys), jnp.asarray(vals),
                                  jgrnnd.GRNNDConfig(**CFG._asdict()))
    store = convert.knn_datastore_from_jax(jstore, device=CPU)
    for jhook, hook in (
        (None, None),
        (jknn.make_logit_hook(jstore, cfg.vocab, lam=0.3),
         knn_lm.make_logit_hook(store, cfg.vocab, lam=0.3)),
    ):
        want = JServeEngine(jcfg, jparams, s_max=16, act_dtype=jnp.float32, logit_hook=jhook)
        got = ServeEngine(cfg, params, s_max=16, act_dtype=torch.float32, logit_hook=hook,
                          device=CPU)
        w = want.generate({"tokens": jnp.asarray(tokens)}, max_new_tokens=6)
        g = got.generate({"tokens": tokens}, max_new_tokens=6)
        assert g["tokens"].dtype == torch.int32
        assert np.array_equal(g["tokens"].numpy(), np.asarray(w["tokens"]))
        assert np.array_equal(g["final_pos"].numpy(), np.asarray(w["final_pos"]))


def test_generate_matches_the_reference_engine(lm):
    _generate_with_and_without_a_hook(lm)


def test_generate_with_knn_hooks_over_moe_matches_the_reference_engine():
    cfg, params, jcfg, jparams, batch = make_model("deepseek-moe-16b", b=2, s=8)
    _generate_with_and_without_a_hook((cfg, params, jcfg, jparams, batch["tokens"]))


def test_real_logit_hook_runs_inside_generate(lm):
    """The two-argument logit hook runs every step, the stream hook grows
    the datastore during decode, and `return_hidden=True` is honoured:
    ``hidden[:, t]`` is the state ``tokens[:, t]`` was sampled from."""
    cfg, params, _, _, tokens = lm
    rng = np.random.default_rng(3)
    keys = rng.standard_normal((N, cfg.d_model)).astype(np.float32)
    vals = rng.integers(0, cfg.vocab, N).astype(np.int32)
    ds = DynamicDatastore.build(keys, vals, cfg.vocab, build_cfg=CFG, draws=Draws(2, CPU),
                                device=CPU, precision="fp32", k=4, ef=32)
    calls = []
    fuse_hook = knn_lm.make_logit_hook(ds, lam=0.3)

    def spy(lm_logits, hidden):
        calls.append((tuple(lm_logits.shape), tuple(hidden.shape)))
        return fuse_hook(lm_logits, hidden)

    stream = knn_lm.make_stream_hook(ds, insert_every=2)
    eng = ServeEngine(cfg, params, s_max=16, act_dtype=torch.float32, logit_hook=spy,
                      token_hook=stream, device=CPU)
    n0 = len(ds)
    out = eng.generate({"tokens": tokens}, max_new_tokens=4, return_hidden=True)
    stream.flush()
    assert out["tokens"].shape == (2, 4)
    assert out["hidden"].shape == (2, 4, cfg.d_model)
    assert calls == [((2, cfg.vocab), (2, cfg.d_model))] * 4
    assert len(ds) == n0 + 8  # 4 steps x batch 2 streamed in
    # re-fusing outside the engine reproduces the greedy choice of step 0,
    # whose hidden state was streamed in after the choice was made
    assert ds.knn_log_probs(out["hidden"][:, 0]).shape == (2, cfg.vocab)
    assert torch.equal(ds.values[n0 : n0 + 2], out["tokens"][:, 0])


@pytest.mark.parametrize("rows", [2, 1], ids=["one-row-stops", "all-rows-stop"])
def test_eos_stops_like_the_reference_engine(lm, rows):
    """With `eos_id` set to a token the greedy decode emits at step 2, a row
    that emits it keeps emitting it and the loop ends once every row has:
    tokens and `final_pos` equal the reference engine's."""
    cfg, params, jcfg, jparams, tokens = lm
    tokens = tokens[:rows]
    want = JServeEngine(jcfg, jparams, s_max=16, act_dtype=jnp.float32)
    got = ServeEngine(cfg, params, s_max=16, act_dtype=torch.float32, device=CPU)
    eos = int(np.asarray(want.generate({"tokens": jnp.asarray(tokens)}, max_new_tokens=6)
                         ["tokens"])[0, 2])
    w = want.generate({"tokens": jnp.asarray(tokens)}, max_new_tokens=6, eos_id=eos)
    g = got.generate({"tokens": tokens}, max_new_tokens=6, eos_id=eos)
    assert np.array_equal(g["tokens"].numpy(), np.asarray(w["tokens"]))
    assert np.array_equal(g["final_pos"].numpy(), np.asarray(w["final_pos"]))
    assert (g["tokens"][0, 2:] == eos).all()
    if rows == 1:
        assert g["tokens"].shape == (1, 3)  # stopped after the step that emitted eos


def test_seeded_temperature_sampling_repeats_and_keeps_to_the_support(lm):
    """Temperature sampling draws from the engine's own generator: two
    engines with one seed emit the same tokens, and every token has nonzero
    probability (a hook leaves three tokens a row finite)."""
    cfg, params, _, _, tokens = lm
    allowed = torch.tensor([[3, 17, 40], [5, 9, 77]])

    def keep_three(lm_logits, hidden):
        out = torch.full_like(lm_logits, -torch.inf)
        return out.scatter(1, allowed, lm_logits.gather(1, allowed))

    def run(seed):
        eng = ServeEngine(cfg, params, s_max=16, act_dtype=torch.float32, logit_hook=keep_three,
                          seed=seed, device=CPU)
        return eng.generate({"tokens": tokens}, max_new_tokens=8, temperature=1.0)["tokens"]

    a, b = run(5), run(5)
    assert torch.equal(a, b)
    assert all(bool(torch.isin(a[i], allowed[i]).all()) for i in range(2))


def test_distance_excess_reads_zero_at_the_truth_and_one_at_random_rows(pairs):
    """`distance_excess`, the continuous retrieval measure phase 4i holds
    the kernels to where recall by ids reads ~0: 0 for the true neighbors,
    1 for the random rows themselves, a found id < 0 left out, and a built
    graph's search in between, nearer the truth than random neighbors;
    `pool_excess` reads 0 for pools that are the true neighbors (in any
    order, -1 padded) and a built graph's pools in between."""
    x, _ = pairs
    q = x[:40] + 0.1 * np.random.default_rng(5).standard_normal((40, DIM)).astype(np.float32)
    true = brute_force_knn(x, q, 10, device=CPU)
    rand = torch.from_numpy(np.random.default_rng(6).integers(0, N, (40, 10)))
    assert distance_excess(x, q, true, true, rand) == 0.0
    assert distance_excess(x, q, rand, true, rand) == pytest.approx(1.0)
    padded = torch.cat([true[:, :5], torch.full((40, 5), -1, dtype=torch.int32)], 1)
    assert distance_excess(x, q, padded, true, rand) < 0  # the 5 nearest beat the 10's mean
    pool = build_graph(x, CFG, draws=Draws(2, CPU), device=CPU)
    found = search(x, pool.ids, q, k=10, ef=EF, device=CPU).ids
    assert 0.0 <= distance_excess(x, q, found, true, rand) < 0.5
    verts = torch.arange(0, N, 6)
    vtrue = brute_force_knn(x, x[verts.numpy()], 11, device=CPU)[:, 1:]
    vrand = torch.from_numpy(np.random.default_rng(7).integers(0, N, (len(verts), 10)))
    pools = torch.full((N, 16), -1, dtype=torch.int32)
    pools[verts, :10] = vtrue.flip(1)
    assert pool_excess(x, verts, pools, vtrue, vrand) == 0.0
    assert 0.0 < pool_excess(x, verts, pool.ids, vtrue, vrand) < 1.0
