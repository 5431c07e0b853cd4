"""The port's plain kernels (repro_torch.kernels.ref) against the JAX oracles.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: fp32 distances agree to rtol 1e-5 / atol 1e-5, because torch-CPU
and XLA:CPU sum D products in different orders (measured max rel. error
3.6e-7 at these sizes); pairwise distances, computed through the norm
decomposition, to atol 1e-4 (cancellation against |x|^2 ~ D). Integer and
bool outputs are equal, except where a float comparison sits within the
distance tolerance of its threshold (rng_round's hit test).

B1-B3 and B6 are also held against their Pallas kernels in interpret mode,
as tests/test_rng_round.py runs them. The storage variants (bf16, int8 with
the per-dimension scale/offset) and the tombstone mask are held the same
way: the stored bytes are handed over through `convert.store_from_jax`, and
the dequantized rows agree to an ulp (XLA may fuse the dequant's multiply
and add), so the distance tolerances above hold unchanged. The dispatch
tests check that `ops` sends CPU tensors to the plain version and that a
kernel wrapper never falls back for a tensor that is not on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vecstore as jvs
from repro.kernels import ref as jref
from repro.kernels.gather_l2 import gather_sqdist_pallas
from repro.kernels.rng_round import rng_round_pallas
from repro.kernels.search_expand import search_expand_pallas
from repro.kernels.topr_merge import topr_merge_pallas
from repro_torch import convert
from repro_torch.core import vecstore as VS
from repro_torch.kernels import ops, ref
from repro_torch.kernels.gather_l2 import gather_sqdist
from repro_torch.kernels.pairwise_l2 import pairwise_sqdist, rowwise_sqdist
from repro_torch.kernels.rng_round import rng_round
from repro_torch.kernels.search_expand import search_expand
from repro_torch.kernels.topr_merge import topr_merge
from test_torch_cuda import MERGE_WIDTHS, merge_cases

# the suite runs in parallel workers: one intra-op thread each keeps torch
# from oversubscribing the cores the JAX tests share
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5
PAIRWISE_ATOL = 1e-4

# the JAX oracles, jitted: eager JAX compiles every op anew per shape
_rng_round_jref = jax.jit(jref.rng_round_ref)
_topr_merge_jref = jax.jit(jref.topr_merge_ref, static_argnums=(2,))
_search_expand_jref = jax.jit(jref.search_expand_ref)
_gather_jref = jax.jit(jref.gather_sqdist_ref)
_pairwise_jref = jax.jit(jref.pairwise_sqdist_ref)

RUNGS = ("fp32", "bf16", "int8")


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _pool_inputs(seed, n, d, r, p, s):
    """A random S-NN pool with true distances, sorted, in R slots (the state
    `init_random` leaves), plus sampled slot pairs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    ids = np.full((n, r), -1, np.int32)
    dists = np.full((n, r), np.inf, np.float32)
    for v in range(n):
        nb = rng.choice(np.delete(np.arange(n), v), s, replace=False)
        dv = ((x[nb] - x[v]) ** 2).sum(-1)
        order = np.argsort(dv)
        ids[v, :s], dists[v, :s] = nb[order], dv[order]
    si = rng.integers(0, r, (n, p), dtype=np.int32)
    sj = rng.integers(0, r, (n, p), dtype=np.int32)
    return x, ids, dists, si, sj


def _assert_round_close(got, want, ids, dists, si, sj):
    """rng_round outputs agree; integer mismatches only at near-ties."""
    g = [_np(a) for a in got]
    w = [_np(a) for a in want]
    np.testing.assert_allclose(g[2], w[2], rtol=RTOL, atol=ATOL, err_msg="dij")
    np.testing.assert_array_equal(g[1], w[1], err_msg="src")
    thr = np.maximum(np.take_along_axis(dists, si, 1), np.take_along_axis(dists, sj, 1))
    near = np.abs(w[2] - thr) <= ATOL + RTOL * np.abs(thr)
    bad = (g[0] != w[0]) & ~near
    assert not bad.any(), f"dst differs away from a near-tie at {np.argwhere(bad)[:5]}"
    kill_bad = g[3] != w[3]
    rows = np.nonzero(kill_bad.any(1))[0]
    assert all(near[i].any() for i in rows), "kill differs in a row with no near-tie"


@pytest.mark.parametrize(
    "n,d,r,p,s",
    [(64, 16, 8, 8, 6), (50, 33, 12, 16, 12), (40, 130, 7, 5, 4), (48, 128, 16, 16, 8)],
)
def test_rng_round_ref_matches_jax_oracle_and_pallas(n, d, r, p, s):
    x, ids, dists, si, sj = _pool_inputs(n + d, n, d, r, p, s)
    got = ref.rng_round_ref(_t(x), _t(ids), _t(dists), _t(si), _t(sj))
    assert [a.dtype for a in got] == [torch.int32, torch.int32, torch.float32, torch.bool]
    want = _rng_round_jref(x, ids, dists, si, sj)
    _assert_round_close(got, want, ids, dists, si, sj)
    # interpret mode steps the (C, R) grid in Python: hold a chunk of 8
    # vertices (rows are independent) against it
    c = 8
    pallas = rng_round_pallas(x, ids[:c], dists[:c], si[:c], sj[:c], interpret=True)
    _assert_round_close([a[:c] for a in got], pallas, ids[:c], dists[:c], si[:c], sj[:c])


def test_rng_round_ref_blocks_rows_like_one_pass(monkeypatch):
    x, ids, dists, si, sj = _pool_inputs(3, 64, 16, 8, 8, 6)
    args = [_t(a) for a in (x, ids, dists, si, sj)]
    whole = ref.rng_round_ref(*args)
    monkeypatch.setattr(ref, "_BLOCK_ELEMS", 8 * 16 * 5)  # 5 rows per block
    blocked = ref.rng_round_ref(*args)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


def _merge_inputs(seed, b, w):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, max(2, w // 2), (b, w)).astype(np.int32)
    dists = rng.random((b, w)).astype(np.float32)
    dists[rng.random((b, w)) < 0.1] = np.inf
    # exact distance ties, so the tie order is checked too
    dists[:, ::3] = np.round(dists[:, ::3], 1)
    return ids, dists


@pytest.mark.parametrize("b,w,r", [(6, 24, 8), (5, 96, 48), (4, 7, 12), (3, 176, 128)])
def test_topr_merge_ref_equals_jax_oracle_and_pallas(b, w, r):
    ids, dists = _merge_inputs(b * w + r, b, w)
    gi, gd = ref.topr_merge_ref(_t(ids), _t(dists), r)
    assert gi.shape == (b, r) and gi.dtype == torch.int32
    wants = [_topr_merge_jref(ids, dists, r)]
    if r <= 48:  # the Pallas body unrolls r selection rounds at trace time
        wants.append(
            topr_merge_pallas(jnp.asarray(ids), jnp.asarray(dists), r, br=4, interpret=True)
        )
    for wi, wd in wants:
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("w", MERGE_WIDTHS)
@pytest.mark.parametrize("wider", [False, True])
def test_topr_merge_adversarial_rows_equal_jax_oracle(w, wider):
    """All-duplicate rows, a repeat at a lower distance, ties across the
    r-th slot, -1 rows and slots, ids near 2^31 - 1: exactly the oracle's."""
    r = w + 7 if wider else max(1, w // 2)
    ids, dists = merge_cases(w)
    gi, gd = topr_merge(_t(ids), _t(dists), r)
    wi, wd = _topr_merge_jref(ids, dists, r)
    assert gi.shape == (ids.shape[0], r)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def _expand_inputs(seed, n, d, q, r, h):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    nbrs = rng.integers(-1, n, (q, r)).astype(np.int32)
    table = np.full((q, h), -1, np.int32)
    # half of each row's neighbors already visited, at their first probe slot
    for i in range(q):
        for v in nbrs[i, : r // 2]:
            if v >= 0:
                table[i, v % h] = v
    return x, queries, nbrs, table


@pytest.mark.parametrize(
    "n,d,q,r,h", [(200, 16, 6, 8, 64), (300, 33, 5, 12, 512), (100, 128, 4, 48, 1)]
)
def test_search_expand_ref_matches_jax_oracle_and_pallas(n, d, q, r, h):
    x, queries, nbrs, table = _expand_inputs(n + q, n, d, q, r, h)
    gi, gd, gf = ref.search_expand_ref(_t(x), _t(queries), _t(nbrs), _t(table))
    assert (gi.dtype, gd.dtype, gf.dtype) == (torch.int32, torch.float32, torch.bool)
    for wi, wd, wf in (
        _search_expand_jref(x, queries, nbrs, table),
        search_expand_pallas(x, queries, nbrs, table, interpret=True),
    ):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m,n,d", [(7, 50, 16), (33, 65, 128), (5, 40, 960)])
def test_pairwise_sqdist_ref_matches_jax_oracle(m, n, d):
    rng = np.random.default_rng(m + n + d)
    x = rng.standard_normal((m, d)).astype(np.float32)
    y = rng.standard_normal((n, d)).astype(np.float32)
    got = ref.pairwise_sqdist_ref(_t(x), _t(y)).numpy()
    want = np.asarray(jref.pairwise_sqdist_ref(x, y))
    np.testing.assert_allclose(got, want, atol=PAIRWISE_ATOL)
    assert (got >= 0).all()


@pytest.mark.parametrize("m,d", [(9, 16), (64, 128), (3, 960)])
def test_rowwise_sqdist_ref_matches_jax_oracle(m, d):
    rng = np.random.default_rng(m * d)
    x = rng.standard_normal((m, d)).astype(np.float32)
    y = rng.standard_normal((m, d)).astype(np.float32)
    got = ref.rowwise_sqdist_ref(_t(x), _t(y)).numpy()
    want = np.asarray(jref.rowwise_sqdist_ref(x, y))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("h", [1, 7, 512])
def test_visited_probe_positions_equal_jax(h):
    ids = np.arange(-3, 2000, 7, dtype=np.int32).reshape(-1, 1)
    got = ref.visited_probe_positions(_t(ids), h).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.visited_probe_positions(ids, h)))
    assert ref.HASH_PROBES == jref.HASH_PROBES


def test_ops_sends_cpu_tensors_to_the_plain_versions():
    x, ids, dists, si, sj = (_t(a) for a in _pool_inputs(5, 40, 16, 8, 8, 6))
    assert ops.effective_backend("cpu") == "ref"
    with ops.backend("ref"):
        assert ops.get_backend() == "ref"
        assert ops.effective_backend("cuda") == "ref"
        want = ops.rng_propagation_round(x, ids, dists, si, sj)
    assert ops.get_backend() == "auto" and ops.effective_backend("cuda") == "cuda"
    before = ops.launch_counts()
    for a, b in zip(ops.rng_propagation_round(x, ids, dists, si, sj), want):
        assert torch.equal(a, b)
    assert torch.equal(ops.topr_merge(ids, dists, 8)[0], ref.topr_merge_ref(ids, dists, 8)[0])
    assert torch.equal(ops.rowwise_sqdist(x, x), ref.rowwise_sqdist_ref(x, x))
    assert torch.equal(ops.pairwise_sqdist(x[:3], x), ref.pairwise_sqdist_ref(x[:3], x))
    table = torch.full((4, 16), -1, dtype=torch.int32)
    for a, b in zip(
        ops.search_expand(x, x[:4], ids[:4], table), ref.search_expand_ref(x, x[:4], ids[:4], table)
    ):
        assert torch.equal(a, b)
    assert ops.launch_counts() == before  # the plain versions launch nothing
    with pytest.raises(ValueError):
        ops.set_backend("cuda-if-available")


def test_kernel_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; here
    (meta tensors) it raises before any build."""
    m = torch.empty((8, 16), device="meta")
    i = torch.empty((8, 4), dtype=torch.int32, device="meta")
    f = torch.empty((8, 4), device="meta")
    calls = [
        lambda: pairwise_sqdist(m, m),
        lambda: rowwise_sqdist(m, m),
        lambda: rng_round(m, i, f, i, i),
        lambda: topr_merge(i, f, 2),
        lambda: search_expand(m, m, i, i),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()


# ---------------------------------------------------------------------------
# storage variants, the tombstone mask and B6 (gather_sqdist)
# ---------------------------------------------------------------------------


def _stores(x: np.ndarray, precision: str):
    """The same rows stored at `precision` in both packages: the JAX store
    and the port's (data, scale, offset) carrying its bytes."""
    jstore = jvs.encode(jnp.asarray(x), precision)
    parts = [None if a is None else np.asarray(a) for a in jstore]
    return jstore, tuple(convert.store_from_jax(*parts, device="cpu"))


def test_dequant_rows_matches_jax():
    x = np.random.default_rng(0).standard_normal((50, 33)).astype(np.float32)
    for precision in RUNGS:
        jstore, (data, scale, offset) = _stores(x, precision)
        got = ref.dequant_rows(data, scale, offset)
        assert got.dtype == torch.float32
        want = jref.dequant_rows(jstore.data, jstore.scale, jstore.offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("n,d,m", [(60, 33, 24), (40, 128, 16)])
def test_gather_sqdist_ref_matches_jax_oracle_and_pallas(precision, n, d, m):
    rng = np.random.default_rng(n + d + m)
    x = rng.standard_normal((n, d)).astype(np.float32)
    ni = rng.integers(-3, n + 3, m).astype(np.int32)  # out of range: clamped
    nj = rng.integers(0, n, m).astype(np.int32)
    jstore, (data, scale, offset) = _stores(x, precision)
    got = ref.gather_sqdist_ref(data, _t(ni), _t(nj), scale, offset)
    assert got.dtype == torch.float32 and got.shape == (m,)
    for want in (
        _gather_jref(jstore.data, ni, nj, jstore.scale, jstore.offset),
        gather_sqdist_pallas(jstore.data, ni, nj, jstore.scale, jstore.offset, interpret=True),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_gather_sqdist_ref_blocks_rows_like_one_pass(monkeypatch):
    rng = np.random.default_rng(1)
    data, scale, offset = VS.encode(torch.from_numpy(rng.standard_normal((30, 16))), "int8")
    ni = torch.from_numpy(rng.integers(0, 30, 100).astype(np.int32))
    nj = torch.from_numpy(rng.integers(0, 30, 100).astype(np.int32))
    whole = ref.gather_sqdist_ref(data, ni, nj, scale, offset)
    monkeypatch.setattr(ref, "_BLOCK_ELEMS", 16 * 7)  # 7 pairs per block
    assert torch.equal(whole, ref.gather_sqdist_ref(data, ni, nj, scale, offset))
    with pytest.raises(ValueError, match="no rows"):
        ref.gather_sqdist_ref(data[:0], ni, nj, scale, offset)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("n,d,r,p,s", [(64, 16, 8, 8, 6), (50, 33, 12, 16, 12)])
def test_rng_round_ref_quantized_matches_jax_oracle_and_pallas(precision, n, d, r, p, s):
    x, ids, dists, si, sj = _pool_inputs(n * d, n, d, r, p, s)
    jstore, (data, scale, offset) = _stores(x, precision)
    got = ref.rng_round_ref(data, _t(ids), _t(dists), _t(si), _t(sj), scale, offset)
    want = _rng_round_jref(jstore.data, ids, dists, si, sj, jstore.scale, jstore.offset)
    _assert_round_close(got, want, ids, dists, si, sj)
    c = 8
    pallas = rng_round_pallas(
        jstore.data, ids[:c], dists[:c], si[:c], sj[:c], jstore.scale, jstore.offset, interpret=True
    )
    _assert_round_close([a[:c] for a in got], pallas, ids[:c], dists[:c], si[:c], sj[:c])


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("live_frac", [0.7, 0.0, 1.0])
def test_search_expand_ref_valid_and_quantized_match_jax_oracle_and_pallas(precision, live_frac):
    n, d, q, r, h = 120, 33, 5, 12, 64
    x, queries, nbrs, table = _expand_inputs(7, n, d, q, r, h)
    valid = np.random.default_rng(8).random(n) < live_frac
    jstore, (data, scale, offset) = _stores(x, precision)
    gi, gd, gf = ref.search_expand_ref(
        data, _t(queries), _t(nbrs), _t(table), _t(valid), scale, offset
    )
    dead = (nbrs >= 0) & ~valid[np.clip(nbrs, 0, None)]
    assert (gi.numpy()[dead] == -1).all() and np.isinf(gd.numpy()[dead]).all()
    assert not gf.numpy()[dead].any()
    args = (jstore.data, queries, nbrs, table, valid, jstore.scale, jstore.offset)
    for wi, wd, wf in (_search_expand_jref(*args), search_expand_pallas(*args, interpret=True)):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=RTOL, atol=ATOL)
    if live_frac == 1.0:  # an all-live mask is the unmasked step
        plain = ref.search_expand_ref(data, _t(queries), _t(nbrs), _t(table), None, scale, offset)
        for a, b in zip(plain, (gi, gd, gf)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("xp,yp", [("fp32", "int8"), ("int8", "int8"), ("bf16", "int8")])
def test_pairwise_sqdist_ref_quantized_matches_jax_oracle(xp, yp):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((9, 33)).astype(np.float32)
    y = rng.standard_normal((70, 33)).astype(np.float32)
    jx, (xd, xs, xo) = _stores(x, xp)
    jy, (yd, ys, yo) = _stores(y, yp)
    got = ref.pairwise_sqdist_ref(xd, yd, xs, xo, ys, yo).numpy()
    want = _pairwise_jref(jx.data, jy.data, jx.scale, jx.offset, jy.scale, jy.offset)
    np.testing.assert_allclose(got, np.asarray(want), atol=PAIRWISE_ATOL)
    assert (got >= 0).all()


def test_ops_reads_stores_and_the_mask():
    """`ops` duck-types a VectorStore into its (data, scale, offset) parts on
    every distance entry point, and passes the tombstone mask through."""
    rng = np.random.default_rng(4)
    x, ids, dists, si, sj = (_t(a) for a in _pool_inputs(6, 40, 16, 8, 8, 6))
    store = VS.encode(x, "int8")
    assert ops.parts(store) == tuple(store) and ops.parts(x) == (x, None, None)
    ni = torch.from_numpy(rng.integers(0, 40, 50).astype(np.int32))
    before = ops.launch_counts()
    nj = ni.flip(0)
    assert torch.equal(
        ops.gather_sqdist(store, ni, nj),
        ref.gather_sqdist_ref(store.data, ni, nj, store.scale, store.offset),
    )
    for a, b in zip(
        ops.rng_propagation_round(store, ids, dists, si, sj),
        ref.rng_round_ref(store.data, ids, dists, si, sj, store.scale, store.offset),
    ):
        assert torch.equal(a, b)
    assert torch.equal(
        ops.pairwise_sqdist(x[:3], store),
        ref.pairwise_sqdist_ref(x[:3], store.data, None, None, store.scale, store.offset),
    )
    table = torch.full((4, 16), -1, dtype=torch.int32)
    valid = torch.from_numpy(rng.random(40) < 0.5)
    for a, b in zip(
        ops.search_expand(store, x[:4], ids[:4], table, valid),
        ref.search_expand_ref(store.data, x[:4], ids[:4], table, valid, store.scale, store.offset),
    ):
        assert torch.equal(a, b)
    with ops.backend("ref"):
        assert torch.equal(ops.gather_sqdist(store, ni, ni), torch.zeros(50))
    assert ops.launch_counts() == before  # the plain versions launch nothing
    # the filter operands are ported; one of them without the other raises
    for fn in (ops.search_expand, ref.search_expand_ref):
        with pytest.raises(ValueError, match="both vwords and fwords"):
            fn(store if fn is ops.search_expand else x, x[:4], ids[:4], table, vwords=table)


def test_variant_wrappers_never_fall_back_off_the_cpu():
    """The storage variants, the mask and B6 also go to the kernel or raise
    for a tensor that is not on the CPU (here: meta tensors, before any
    build)."""
    q8 = torch.empty((8, 16), dtype=torch.int8, device="meta")
    f = torch.empty((8, 16), device="meta")
    s = torch.empty((16,), device="meta")
    i = torch.empty((8, 4), dtype=torch.int32, device="meta")
    d = torch.empty((8, 4), device="meta")
    v = torch.empty((8,), dtype=torch.bool, device="meta")
    calls = [
        lambda: gather_sqdist(q8, i[:, 0], i[:, 1], s, s),
        lambda: gather_sqdist(f, i[:, 0], i[:, 1]),
        lambda: rng_round(q8, i, d, i, i, s, s),
        lambda: search_expand(q8, f, i, i, v, s, s),
        lambda: pairwise_sqdist(f, q8, None, None, s, s),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
