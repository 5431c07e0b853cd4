"""The hand-written CUDA kernels against their plain versions, on the card.

Marked `cuda`: without a card every test here skips. On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes cover the ragged cases the main path does not (D not a multiple of 4,
W < r, M and N off pairwise's 128-row tiles, D off its 32-deep K-slabs, M
on both sides of its row-streaming kernel's M <= 4, rows that are not
16-byte aligned, search_expand at R = 1, 13, 48 and 64 with rows of -1
ids and D = 960, the 1-slot dense-mode table), and the
storage variants (bf16, int8 with scale/offset) and tombstone mask of the
dynamic path at D = 33 (no 16-byte row loads) and D = 128, with N off the
block sizes, and the label filter of search_expand at W = 1, 3, 4 and 5
words (int4 loads only at W = 4) and R = 13 (not a multiple of a lane
group), with labels on the int32 sign bit; the adversarial merge rows of
`merge_cases` at W = 1 ... 8192 with r below and above W (every group width
of 1 to 1024 threads a row, packed and unpacked); the merge that carries
the beam's expanded flags on beam rows (`tests/_beam_rows.py`) at the beam
merges' widths, sparse and dense, against the plain flagged merge and the id
match it replaces, and on random rows at every group width, launched once a
search step and never by a build; and rng_round at each
storage rung with rows copied by bulk copies (D = 128), plainly (D = 33) and
into a row buffer that leaves one to four blocks an SM (D = 960); gather_sqdist
on the re-base's runs of equal owners at 1 to 8 quads a lane and past them
(D = 16 ... 1040), with runs that straddle the groups' ranges and batches,
N = 1, and the same pairs shuffled (bitwise the sorted result), and at
fp32 on the sharded build's merge pairs (runs of 8 owners beside
candidates from the other shards); search_expand as one shard of the
corpus-sharded search runs it (3/4 of the slots masked, a 1-slot table),
and that search bitwise the replicated one on the card; and the
visited insert at H = 1, 3, 8, 512, 4096 and R = 1, 20, 48, bitwise the column
loop; and at gemma3-1b's width D = 1152 (the kNN-LM datastore's rows): B1
at R = P = 24 and 48 and on its direct-read path past its shared memory at
R = 64, B3 at Q = 32 and
1,000 with the mask, B6 on the re-base's runs, each at every storage rung,
the deterministic vote, and the fp32 datastore bitwise the array-backed
path and the engine-routed retrieval; B1's forced direct-read path bitwise
its staged path at D = 128 and 1152 at every storage rung, and within
tolerance of the plain version at D = 3584 and 4096 (zamba2-7b's and
qwen3-moe's widths, where only the direct path runs); the MoE block bitwise
across two calls at T = 4,096 tokens (no float atomics in its combine) and
the chunked SSD scan against the recurrence at zamba2's head shapes; one
training step of each of the ten families at reduced() width against the
same step on the CPU port (loss within 1e-4, gradients within 1e-3 of each
leaf's largest magnitude), and resumed training bitwise uninterrupted
training under `torch.use_deterministic_algorithms`; and a build that
waits for the card (`torch.cuda.set_sync_debug_mode`) exactly as often as
it passes its counted sync sites (`repro_torch.trace.SYNCS`), with the
staging in one pass and in slices, and a hashed search that drains the
stream only at its entry's gather (its frontier waits are event waits);
and at 2·10^6 rows a build staged in slices bitwise the one-pass build; and
at 2·10^5 rows every staging of a build at the paper's SIFT1M settings (its
active requests alone) bitwise the uncompacted one pass.
Tolerances: fp32 distances to rtol 1e-5 / atol 1e-4 (other
summation order; the dequant itself is bitwise the plain version's);
pairwise to 1e-5 of |x|^2 + |y|^2 (norm-decomposition cancellation);
topr_merge, the visited tables and every integer output exactly, except rng_round's hit test
within that tolerance of its threshold.
"""

import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import (
    Draws,
    HostTier,
    encode_labels,
    optimize,
    predicate_fraction,
    random_query_filters,
    DynamicConfig,
    DynamicIndex,
    GRNNDConfig,
    brute_force_knn,
    build_graph,
    encode,
    medoid,
    recall_at_k,
    search,
)
from repro_torch import trace
from repro_torch.configs.grnnd_paper import SIFT1M
from repro_torch.core import corpus_shard as CS
from repro_torch.core import pools
from repro_torch.core.labels import pack_ids
from repro_torch.core.search import _table_insert
from repro_torch.data import synthetic
from repro_torch.kernels import ops, ref
from repro_torch.kernels.gather_l2 import gather_sqdist
from repro_torch.kernels.pairwise_l2 import pairwise_sqdist, rowwise_sqdist
from repro_torch.kernels.rng_round import rng_round
from repro_torch.kernels.search_expand import search_expand
from repro_torch.kernels.topr_merge import topr_merge
from repro_torch.kernels.visited_insert import visited_insert
from _beam_rows import beam_rows, match_flags
from _stage_oracle import active, one_pass

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launched(name, fn):
    before = ops.launch_counts().get(name, 0)
    out = fn()
    torch.cuda.synchronize()
    assert ops.launch_counts().get(name, 0) == before + 1
    return out


def _store(x, precision):
    """(data, scale, offset) of `x` encoded at `precision`."""
    return tuple(encode(x, precision))


RUNGS = ("fp32", "bf16", "int8")

# widths of the adversarial merge rows, one or two for each group width
# L = next_pow2(ceil(W / 8)) threads a row from 1 to 1024: tiny, the build's
# 96, the ef-64 / ef-128 beam merges' 112 / 176, past one warp's 128, the
# filtered ef-400 / ef-512 beam merges' 448 / 560, and up to the limit
MERGE_WIDTHS = (1, 5, 9, 16, 31, 48, 96, 112, 129, 176, 448, 560, 2000, 4000, 8192)


def merge_cases(w: int, seed: int = 0):
    """(10, W) int32 ids / fp32 dists of adversarial merge rows, from numpy:
    0: one id in every slot; 1: each id again later at a lower distance
    (the first position must win); 2: two distance levels only, so ties
    straddle any r-th slot; 3: all -1; 4: -1 ids with finite distances;
    5: ids near 2^31 - 1, repeated; 6: +inf distances on live ids;
    7-9: random ids with repeats and exact ties."""
    rng = np.random.default_rng(seed + w)
    ids = rng.integers(0, max(2, w // 2), (10, w)).astype(np.int32)
    dists = rng.random((10, w)).astype(np.float32)
    dists[:, ::3] = np.round(dists[:, ::3], 1)
    pos = np.arange(w, dtype=np.int32)
    h = (w + 1) // 2
    ids[0] = 7
    ids[1] = np.concatenate([pos[:h], pos[: w - h]])
    dists[1, h:] = dists[1, : w - h] * 0.5
    ids[2], dists[2] = pos, np.where(pos % 3 == 0, 0.25, 0.5)
    ids[3] = -1
    ids[4] = np.where(pos % 2 == 0, -1, pos)
    ids[5] = 2**31 - 1 - rng.integers(0, 4, w)
    dists[6, rng.random(w) < 0.3] = np.inf
    ids[7, ::4] = -1
    return ids, dists


# the kNN-LM datastore's shapes at gemma3-1b's D = 1152: B1 at R = P = 24
# (two blocks an SM at fp32) and 48 (221 KB, one), B3 at the retrieval's
# Q = 32 and 1,000 with H = 256 (fp32 rows past the 32 KB async budget,
# int8 rows through it); B6's re-base runs are among REBASE_EDGES (fp32:
# the per-pair kernel past 8 quads a lane)
KNN_ROUNDS = [(3000, 1152, 2000, 24, 24), (3000, 1152, 2000, 48, 48)]
KNN_EXPANDS = [(20_000, 1152, 32, 24, 256), (20_000, 1152, 1000, 24, 256)]

# edges of the 128x128 tiles and 32-deep K-slabs (M, N off the tile, D off
# the slab or off 4) and of the row-streaming kernel for M <= 4
PAIRWISE_EDGES = [(16, 1000, 128), (17, 300, 128), (129, 257, 33), (128, 128, 16),
                  (3, 70_000, 128), (130, 1000, 960), (4, 3001, 33), (5, 3001, 128)]


@pytest.mark.parametrize(
    "m,n,d", [(1, 1000, 128), (70, 130, 33), (1024, 4096, 128), (5, 64, 960)] + PAIRWISE_EDGES
)
def test_pairwise_sqdist_kernel(dev, m, n, d):
    g = torch.Generator(dev).manual_seed(m + n)
    x = torch.randn((m, d), generator=g, device=dev)
    y = torch.randn((n, d), generator=g, device=dev)
    got = _launched("pairwise_sqdist", lambda: pairwise_sqdist(x, y))
    want = ref.pairwise_sqdist_ref(x, y)
    scale = (x * x).sum(-1)[:, None] + (y * y).sum(-1)[None, :]
    assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()
    assert (got >= 0).all()


@pytest.mark.parametrize("m,n,d", [(1, 500, 128), (200, 300, 128), (16, 257, 36)])
def test_pairwise_sqdist_kernel_unaligned_rows(dev, m, n, d):
    """Rows starting 4 bytes past a 16-byte boundary: no async copies, no
    16-byte loads; the same results."""
    g = torch.Generator(dev).manual_seed(m + n + 1)
    xb = torch.randn((m * d + 1,), generator=g, device=dev)
    yb = torch.randn((n * d + 1,), generator=g, device=dev)
    x, y = xb[1:].view(m, d), yb[1:].view(n, d)
    got = _launched("pairwise_sqdist", lambda: pairwise_sqdist(x, y))
    want = ref.pairwise_sqdist_ref(x, y)
    scale = (x * x).sum(-1)[:, None] + (y * y).sum(-1)[None, :]
    assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()


@pytest.mark.parametrize("m,d", [(1, 128), (1000, 33), (100_000, 128)])
def test_rowwise_sqdist_kernel(dev, m, d):
    g = torch.Generator(dev).manual_seed(m)
    x = torch.randn((m, d), generator=g, device=dev)
    y = torch.randn((m, d), generator=g, device=dev)
    got = _launched("rowwise_sqdist", lambda: rowwise_sqdist(x, y))
    torch.testing.assert_close(got, ref.rowwise_sqdist_ref(x, y), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "b,w,r",
    [(1000, 96, 48), (64, 7, 12), (300, 560, 512), (5, 33, 1), (2000, 16, 12), (4000, 448, 400),
     (500, 2000, 1000), (100, 4000, 4096), (50, 8192, 100), (20, 8192, 8192)],
)
def test_topr_merge_kernel_is_exact(dev, b, w, r):
    g = torch.Generator(dev).manual_seed(b + w)
    ids = torch.randint(-1, max(2, w // 2), (b, w), generator=g, device=dev, dtype=torch.int32)
    dists = torch.rand((b, w), generator=g, device=dev)
    dists[:, ::3] = (dists[:, ::3] * 10).round() / 10  # exact ties
    dists[torch.rand((b, w), generator=g, device=dev) < 0.1] = torch.inf
    gi, gd = _launched("topr_merge", lambda: topr_merge(ids, dists, r))
    wi, wd = ref.topr_merge_ref(ids, dists, r)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


@pytest.mark.parametrize("w", MERGE_WIDTHS)
@pytest.mark.parametrize("wider", [False, True])
def test_topr_merge_kernel_adversarial_rows(dev, w, wider):
    r = w + 7 if wider else max(1, w // 2)
    ids, dists = (torch.from_numpy(a).to(dev) for a in merge_cases(w))
    gi, gd = _launched("topr_merge", lambda: topr_merge(ids, dists, r))
    wi, wd = ref.topr_merge_ref(ids, dists, r)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


# the beam merges' (W, r) = (ef + R, ef) at ef 64, 128, 400 and 512 (R = 48),
# their flags on the ef candidates; and a few of the shapes above with F < W
BEAM_FLAG_SHAPES = [(64, 48), (128, 48), (400, 48), (512, 48)]
FLAG_SHAPES = [(1000, 96, 48, 30), (64, 7, 12, 3), (5, 33, 1, 33), (300, 560, 512, 200),
               (500, 2000, 1000, 1500), (20, 8192, 8192, 8192)]


@pytest.mark.parametrize("ef,r", BEAM_FLAG_SHAPES)
@pytest.mark.parametrize("fill", [0.05, 0.2, 0.45, 1.0])
def test_topr_merge_flags_kernel_is_exact(dev, ef, r, fill):
    """Beam rows sparse enough for each packed sort (1, 2, 4 keys a thread
    at W = 112 and 176) and dense enough for the full one: ids, dists and
    flags bitwise the plain flagged merge, the flags the id match the
    search once made, ids and dists those of the merge without flags."""
    ids, dists, expanded = (t.to(dev) for t in beam_rows(2000, ef, r, fill, seed=ef))
    gi, gd, gf = _launched("topr_merge/flags", lambda: topr_merge(ids, dists, ef, expanded))
    wi, wd, wf = ref.topr_merge_ref(ids, dists, ef, expanded)
    assert torch.equal(gi, wi) and torch.equal(gd, wd) and torch.equal(gf, wf)
    assert torch.equal(gf, match_flags(ids[:, :ef], expanded, gi))
    pi, pd = _launched("topr_merge", lambda: topr_merge(ids, dists, ef))
    assert torch.equal(gi, pi) and torch.equal(gd, pd)


@pytest.mark.parametrize("b,w,r,f", FLAG_SHAPES)
def test_topr_merge_flags_kernel_on_any_rows(dev, b, w, r, f):
    """Random rows with repeats in the flagged part too: bitwise the plain
    flagged merge at every group width, r below and above W."""
    g = torch.Generator(dev).manual_seed(b + w + f)
    ids = torch.randint(-1, max(2, w // 2), (b, w), generator=g, device=dev, dtype=torch.int32)
    dists = torch.rand((b, w), generator=g, device=dev)
    dists[:, ::3] = (dists[:, ::3] * 10).round() / 10  # exact ties
    dists[torch.rand((b, w), generator=g, device=dev) < 0.1] = torch.inf
    flags = torch.rand((b, f), generator=g, device=dev) < 0.5
    got = _launched("topr_merge/flags", lambda: topr_merge(ids, dists, r, flags))
    want = ref.topr_merge_ref(ids, dists, r, flags)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("n,d,c,r,p", [(6000, 128, 5000, 48, 48), (900, 33, 800, 12, 16),
                                       (1200, 960, 1000, 48, 48)] + KNN_ROUNDS)
def test_rng_round_kernel_storage_and_row_widths(dev, precision, n, d, c, r, p):
    g = torch.Generator(dev).manual_seed(n + d)
    data, scale, offset = _store(synthetic.vector_dataset(g, n, d), precision)
    ids = torch.randint(0, n, (c, r), generator=g, device=dev, dtype=torch.int32)
    ids[torch.rand((c, r), generator=g, device=dev) < 0.2] = -1
    dists = torch.rand((c, r), generator=g, device=dev) * 2 * d
    dists = torch.where(ids >= 0, dists, torch.inf)
    si = torch.randint(0, r, (c, p), generator=g, device=dev, dtype=torch.int32)
    sj = torch.randint(0, r, (c, p), generator=g, device=dev, dtype=torch.int32)
    args = (data, ids, dists, si, sj, scale, offset)
    name = "rng_round" + ("" if precision == "fp32" else "/" + precision)
    got = _launched(name, lambda: rng_round(*args))
    want = ref.rng_round_ref(*args)
    torch.testing.assert_close(got[2], want[2], rtol=RTOL, atol=ATOL)
    assert torch.equal(got[1], want[1])
    thr = torch.maximum(dists.gather(1, si.long()), dists.gather(1, sj.long()))
    near = (want[2] - thr).abs() <= ATOL + RTOL * thr.abs()
    assert not ((got[0] != want[0]) & ~near).any()
    assert not ((got[3] != want[3]).any(1) & ~near.any(1)).any()


@pytest.mark.parametrize("n,d,c,r,p", [(5000, 128, 3000, 48, 48), (700, 33, 700, 12, 16)])
def test_rng_round_kernel(dev, n, d, c, r, p):
    g = torch.Generator(dev).manual_seed(n)
    x = synthetic.vector_dataset(g, n, d)
    ids = torch.randint(0, n, (c, r), generator=g, device=dev, dtype=torch.int32)
    ids[torch.rand((c, r), generator=g, device=dev) < 0.2] = -1
    owners = x[:c].repeat_interleave(r, 0)
    dists = ref.rowwise_sqdist_ref(owners, x[ids.clamp_min(0).long()].reshape(-1, d))
    dists = torch.where(ids >= 0, dists.reshape(c, r), torch.inf)
    si = torch.randint(0, r, (c, p), generator=g, device=dev, dtype=torch.int32)
    sj = torch.randint(0, r, (c, p), generator=g, device=dev, dtype=torch.int32)
    got = _launched("rng_round", lambda: rng_round(x, ids, dists, si, sj))
    want = ref.rng_round_ref(x, ids, dists, si, sj)
    torch.testing.assert_close(got[2], want[2], rtol=RTOL, atol=ATOL)
    assert torch.equal(got[1], want[1])
    thr = torch.maximum(dists.gather(1, si.long()), dists.gather(1, sj.long()))
    near = (want[2] - thr).abs() <= ATOL + RTOL * thr.abs()
    assert not ((got[0] != want[0]) & ~near).any()
    bad_rows = (got[3] != want[3]).any(1)
    assert not (bad_rows & ~near.any(1)).any()


# R = 1, 13, 48 and 64 (a group's neighbors in flight: 1 to 8), D = 33 and
# 960 (no quads; 8 quads a lane), H = 1 (the dense-mode table) and 8
EXPAND_EDGES = [(901, 960, 64, 64, 512), (900, 33, 64, 1, 1), (3001, 128, 100, 13, 8),
                (2000, 960, 50, 1, 512)]


@pytest.mark.parametrize(
    "n,d,q,r,h", [(20_000, 128, 500, 48, 512), (900, 33, 64, 16, 1)] + EXPAND_EDGES
)
def test_search_expand_kernel(dev, n, d, q, r, h):
    g = torch.Generator(dev).manual_seed(n)
    x = torch.randn((n, d), generator=g, device=dev)
    queries = torch.randn((q, d), generator=g, device=dev)
    nbrs = torch.randint(-1, n, (q, r), generator=g, device=dev, dtype=torch.int32)
    nbrs[::7] = -1  # queries with no live neighbor
    table = torch.full((q, h), -1, dtype=torch.int32, device=dev)
    if h > 1:
        _table_insert(table, nbrs[:, : r // 2])
    gi, gd, gf = _launched("search_expand", lambda: search_expand(x, queries, nbrs, table))
    wi, wd, wf = ref.search_expand_ref(x, queries, nbrs, table)
    assert torch.equal(gi, wi) and torch.equal(gf, wf)
    torch.testing.assert_close(gd, wd, rtol=RTOL, atol=ATOL)


def test_build_and_search_on_the_card_match_the_plain_path(dev):
    g = torch.Generator(dev).manual_seed(0)
    x = synthetic.make_preset(g, "sift-like", 4000)
    queries = synthetic.queries_from(g, x, 200)
    cfg = GRNNDConfig(s=12, r=24, t1=3, t2=3, pairs_per_vertex=24)
    truth = brute_force_knn(x, queries, 10, device=dev)
    recalls = []
    for name in ("auto", "ref"):
        with ops.backend(name):
            pool = build_graph(x, cfg, draws=Draws(1, dev), device=dev)
            res = search(x, pool.ids, queries, k=10, ef=48, visited="hashed", device=dev)
        recalls.append(recall_at_k(res.ids, truth))
    assert abs(recalls[0] - recalls[1]) <= 0.01 and recalls[0] >= 0.85, recalls
    assert np.isfinite(res.dists.cpu().numpy()).all()


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("n,d,m", [(1001, 33, 5000), (3000, 128, 70_001), (257, 16, 999)])
def test_gather_sqdist_kernel(dev, precision, n, d, m):
    g = torch.Generator(dev).manual_seed(n + m)
    data, scale, offset = _store(synthetic.vector_dataset(g, n, d), precision)
    ni = torch.randint(-5, n + 5, (m,), generator=g, device=dev, dtype=torch.int32)
    nj = torch.randint(0, n, (m,), generator=g, device=dev, dtype=torch.int32)
    name = "gather_sqdist" + ("" if precision == "fp32" else "/" + precision)
    got = _launched(name, lambda: gather_sqdist(data, ni, nj, scale, offset))
    want = ref.gather_sqdist_ref(data, ni, nj, scale, offset)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="no rows"):
        gather_sqdist(data[:0], ni, nj, scale, offset)


# the re-base's pairs: owner v repeated r times beside v's pool ids. D = 16,
# 64, 128, 960 take the run-aware kernel at 1 to 8 quads a lane (idle lanes
# at D = 16), D = 33 and 1040 the one-pair-a-group kernel; r = 7 runs
# straddle the 4-pair batches, and every case's runs straddle the groups'
# ranges; N = 1 clamps every index to row 0
REBASE_EDGES = [(3000, 128, 48), (1001, 33, 48), (500, 960, 48), (5003, 128, 7),
                (2000, 64, 48), (70_001, 16, 3), (300, 1040, 5), (1, 128, 5), (1, 33, 7),
                (2001, 1152, 24)]


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("n,d,r", REBASE_EDGES)
def test_gather_sqdist_kernel_owner_runs(dev, precision, n, d, r):
    g = torch.Generator(dev).manual_seed(n + d + r)
    data, scale, offset = _store(synthetic.vector_dataset(g, n, d), precision)
    ni = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(r)
    nj = torch.randint(-2, n + 2, (n * r,), generator=g, device=dev, dtype=torch.int32)
    name = "gather_sqdist" + ("" if precision == "fp32" else "/" + precision)
    got = _launched(name, lambda: gather_sqdist(data, ni, nj, scale, offset))
    want = ref.gather_sqdist_ref(data, ni, nj, scale, offset)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    # any ni order: a pair's sum does not depend on its neighbors in the batch
    perm = torch.randperm(n * r, generator=g, device=dev)
    shuffled = gather_sqdist(data, ni[perm].contiguous(), nj[perm].contiguous(), scale, offset)
    assert torch.equal(shuffled, got[perm])


# the sharded build's merge-refine pairs at fp32: owner v in runs of 8
# beside 8 candidates from the other shards, drawn as
# `corpus_shard._cross_candidates` draws them, at S = 4, 3 and 2
@pytest.mark.parametrize("n,d,s", [(40_000, 128, 4), (1001, 33, 3), (5003, 960, 2)])
def test_gather_sqdist_kernel_cross_shard_runs(dev, n, d, s):
    g = torch.Generator(dev).manual_seed(n + d + s)
    x = synthetic.vector_dataset(g, n, d)
    n_loc = CS.shard_bounds(n, s)[1]
    raw = torch.randint(0, 2**31 - 1, (n, 8), generator=g, device=dev, dtype=torch.int32)
    nj = CS._cross_candidates(raw, n, n_loc).reshape(-1)
    ni = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(8)
    assert bool((nj // n_loc != ni // n_loc).all())  # every candidate on another shard
    got = _launched("gather_sqdist", lambda: gather_sqdist(x, ni, nj))
    torch.testing.assert_close(got, ref.gather_sqdist_ref(x, ni, nj), rtol=RTOL, atol=ATOL)


# one shard's step of the corpus-sharded search: the neighbors the shard
# does not own masked to -1 (about (S-1)/S of the slots), local rows into
# its (n_loc, D) slice, and the (Q, 1) table of -1 the corpus body probes
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,d,q,r,s", [(40_003, 128, 1000, 48, 4), (3001, 33, 100, 13, 4),
                                       (2000, 960, 50, 48, 2)])
def test_search_expand_kernel_shard_local(dev, masked, n, d, q, r, s):
    g = torch.Generator(dev).manual_seed(n + q + s)
    x = torch.randn((n, d), generator=g, device=dev)
    queries = torch.randn((q, d), generator=g, device=dev)
    row0s, n_loc = CS.shard_bounds(n, s)
    k = s - 1  # the last shard: its slice has a padded tail where n % s != 0
    x_s = CS._stack_shards(x, row0s, n_loc, 0)[k]
    nbrs = torch.randint(-1, n, (q, r), generator=g, device=dev, dtype=torch.int32)
    owned, loc = CS._owner(nbrs, row0s[k], min(n_loc, n - row0s[k]), n_loc)
    nloc = torch.where(owned, loc, -1).to(torch.int32)
    assert abs(float((nloc < 0).float().mean()) - (1 - 1 / s)) < 0.1
    valid = (torch.rand((n_loc,), generator=g, device=dev) > 0.3) if masked else None
    dummy = torch.full((q, 1), -1, dtype=torch.int32, device=dev)
    name = "search_expand" + ("+valid" if masked else "")
    gi, gd, gf = _launched(name, lambda: search_expand(x_s, queries, nloc, dummy, valid))
    wi, wd, wf = ref.search_expand_ref(x_s, queries, nloc, dummy, valid)
    assert torch.equal(gi, wi) and torch.equal(gf, wf)
    torch.testing.assert_close(gd, wd, rtol=RTOL, atol=ATOL)


def test_corpus_sharded_search_on_the_card_is_search(dev):
    """The sharded search with the kernels is bitwise the replicated one."""
    g = torch.Generator(dev).manual_seed(11)
    x = synthetic.make_preset(g, "sift-like", 20_000)
    queries = synthetic.queries_from(g, x, 300)
    pool = build_graph(x, GRNNDConfig(s=12, r=24, t1=2, t2=3, pairs_per_vertex=24),
                       draws=Draws(1, dev), device=dev)
    for visited in ("dense", "hashed"):
        want = search(x, pool.ids, queries, k=10, ef=48, visited=visited, device=dev)
        for s in (2, 3, 4):
            got = CS.shard(x, pool, s, device=dev).search(queries, k=10, ef=48, visited=visited)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (visited, s)


def insert_cases(rng, q: int, h: int, r: int) -> np.ndarray:
    """(Q, R) int32 ids for the visited insert: -1s, repeats within a row
    and across rows, and rows of ids congruent mod H (one window, filled
    past its 8 slots, so later inserts are dropped)."""
    ids = rng.integers(-1, 20 * h + 40, (q, r)).astype(np.int32)
    ids[:, r // 2 :] = ids[:, : r - r // 2]  # repeats within a row
    ids[1::4] = ids[::4][: len(ids[1::4])]  # repeats across rows
    ids[2::4] = (rng.integers(0, h) + h * np.arange(r, dtype=np.int64)).astype(np.int32)
    return ids


@pytest.mark.parametrize("r", [1, 20, 48])  # 20: a part batch of 16 columns
@pytest.mark.parametrize("h", [1, 3, 8, 512, 4096])
def test_visited_insert_kernel_is_exact(dev, h, r):
    rng = np.random.default_rng(100 * h + r)
    q = 301  # not a multiple of a block's 32 queries
    table = np.full((q, h), -1, np.int32)
    prefill = rng.random((q, h)) < 0.25
    table[prefill] = rng.integers(0, 20 * h, int(prefill.sum()))
    got = torch.from_numpy(table).to(dev)
    want = got.clone()
    for _ in range(3):  # steps in a row fill the tables past their windows
        ids = torch.from_numpy(insert_cases(rng, q, h, r)).to(dev)
        assert _launched("visited_insert", lambda: visited_insert(got, ids)) is got
        ref.visited_insert_ref(want, ids)
        assert torch.equal(got, want)


@pytest.mark.parametrize("precision", ("bf16", "int8"))
@pytest.mark.parametrize("n,d,c,r,p", [(5003, 128, 3001, 48, 48), (700, 33, 699, 12, 16)])
def test_rng_round_kernel_quantized(dev, precision, n, d, c, r, p):
    g = torch.Generator(dev).manual_seed(n + d)
    data, scale, offset = _store(synthetic.vector_dataset(g, n, d), precision)
    xd = ref.dequant_rows(data, scale, offset)
    ids = torch.randint(0, n, (c, r), generator=g, device=dev, dtype=torch.int32)
    ids[torch.rand((c, r), generator=g, device=dev) < 0.2] = -1
    owners = xd[:c].repeat_interleave(r, 0)
    dists = ref.rowwise_sqdist_ref(owners, xd[ids.clamp_min(0).long()].reshape(-1, d))
    dists = torch.where(ids >= 0, dists.reshape(c, r), torch.inf)
    si = torch.randint(0, r, (c, p), generator=g, device=dev, dtype=torch.int32)
    sj = torch.randint(0, r, (c, p), generator=g, device=dev, dtype=torch.int32)
    got = _launched(
        "rng_round/" + precision, lambda: rng_round(data, ids, dists, si, sj, scale, offset)
    )
    want = ref.rng_round_ref(data, ids, dists, si, sj, scale, offset)
    torch.testing.assert_close(got[2], want[2], rtol=RTOL, atol=ATOL)
    assert torch.equal(got[1], want[1])
    thr = torch.maximum(dists.gather(1, si.long()), dists.gather(1, sj.long()))
    near = (want[2] - thr).abs() <= ATOL + RTOL * thr.abs()
    assert not ((got[0] != want[0]) & ~near).any()
    assert not ((got[3] != want[3]).any(1) & ~near.any(1)).any()


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize(
    "n,d,q,r,h", [(20_011, 128, 500, 48, 512), (901, 33, 64, 16, 1)] + EXPAND_EDGES + KNN_EXPANDS
)
def test_search_expand_kernel_variants(dev, precision, masked, n, d, q, r, h):
    g = torch.Generator(dev).manual_seed(n + q)
    data, scale, offset = _store(torch.randn((n, d), generator=g, device=dev), precision)
    queries = torch.randn((q, d), generator=g, device=dev)
    nbrs = torch.randint(-1, n, (q, r), generator=g, device=dev, dtype=torch.int32)
    nbrs[::7] = -1
    table = torch.full((q, h), -1, dtype=torch.int32, device=dev)
    if h > 1:
        _table_insert(table, nbrs[:, : r // 2])
    valid = (torch.rand((n,), generator=g, device=dev) > 0.3) if masked else None
    name = "search_expand" + ("" if precision == "fp32" else "/" + precision)
    name += "+valid" if masked else ""
    gi, gd, gf = _launched(
        name, lambda: search_expand(data, queries, nbrs, table, valid, scale, offset)
    )
    wi, wd, wf = ref.search_expand_ref(data, queries, nbrs, table, valid, scale, offset)
    assert torch.equal(gi, wi) and torch.equal(gf, wf)
    torch.testing.assert_close(gd, wd, rtol=RTOL, atol=ATOL)


def test_search_expand_kernel_fp32_with_dequant(dev):
    """fp32 rows given a scale / offset take the lane-group kernel."""
    g = torch.Generator(dev).manual_seed(7)
    n, d, q, r, h = 901, 36, 64, 16, 1
    x = torch.randn((n, d), generator=g, device=dev)
    scale = torch.rand((d,), generator=g, device=dev) + 0.5
    offset = torch.randn((d,), generator=g, device=dev)
    queries = torch.randn((q, d), generator=g, device=dev)
    nbrs = torch.randint(-1, n, (q, r), generator=g, device=dev, dtype=torch.int32)
    table = torch.full((q, h), -1, dtype=torch.int32, device=dev)
    valid = torch.rand((n,), generator=g, device=dev) > 0.3
    gi, gd, gf = _launched(
        "search_expand+valid",
        lambda: search_expand(x, queries, nbrs, table, valid, scale, offset),
    )
    wi, wd, wf = ref.search_expand_ref(x, queries, nbrs, table, valid, scale, offset)
    assert torch.equal(gi, wi) and torch.equal(gf, wf)
    torch.testing.assert_close(gd, wd, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("xp,yp", [("fp32", "int8"), ("int8", "bf16"), ("bf16", "fp32")])
@pytest.mark.parametrize("m,n,d", [(1, 1003, 128), (70, 130, 33)] + PAIRWISE_EDGES)
def test_pairwise_sqdist_kernel_quantized(dev, xp, yp, m, n, d):
    g = torch.Generator(dev).manual_seed(m + n + d)
    xs = _store(torch.randn((m, d), generator=g, device=dev), xp)
    ys = _store(torch.randn((n, d), generator=g, device=dev), yp)
    rungs = sorted({xp, yp} - {"fp32"})
    got = _launched(
        "pairwise_sqdist/" + "+".join(rungs),
        lambda: pairwise_sqdist(xs[0], ys[0], xs[1], xs[2], ys[1], ys[2]),
    )
    want = ref.pairwise_sqdist_ref(xs[0], ys[0], xs[1], xs[2], ys[1], ys[2])
    xd, yd = ref.dequant_rows(*xs), ref.dequant_rows(*ys)
    scale = (xd * xd).sum(-1)[:, None] + (yd * yd).sum(-1)[None, :]
    assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()


@pytest.mark.parametrize("precision", ("bf16", "int8"))
def test_dynamic_index_on_the_card_matches_the_plain_path(dev, precision):
    """Insert, delete and compact through the kernels and through the plain
    versions with the same draws: recall@10 within 0.02, deleted labels
    never returned, and compaction leaves dense search ids unchanged."""
    g = torch.Generator(dev).manual_seed(3)
    x = synthetic.make_preset(g, "sift-like", 6000)
    queries = synthetic.queries_from(g, x, 300)
    cfg = GRNNDConfig(s=12, r=24, t1=3, t2=3, pairs_per_vertex=24)
    dcfg = DynamicConfig(
        seed_k=8, seed_ef=48, refine_rounds=2, pairs_per_vertex=24, precision=precision
    )
    recalls = []
    for name in ("auto", "ref"):
        with ops.backend(name):
            pool = build_graph(x[:5000], cfg, draws=Draws(4, dev), device=dev)
            idx = DynamicIndex(x[:5000], pool, dcfg, draws=Draws(5, dev), device=dev)
            for lo in range(5000, 6000, 500):
                idx.insert(x[lo : lo + 500])
            dels = torch.arange(0, 6000, 7, device=dev)
            idx.delete(dels)
            res = idx.search(queries, k=10, ef=48)
            assert not torch.isin(res.ids, dels).any()
            recalls.append(recall_at_k(res.ids, idx.exact_knn(queries, 10)))
            before = idx.search(queries, k=10, ef=48)
            idx.compact()
            after = idx.search(queries, k=10, ef=48)
            assert torch.equal(before.ids, after.ids)
    assert abs(recalls[0] - recalls[1]) <= 0.02 and recalls[0] >= 0.85, recalls


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("w", [1, 3, 4, 5])
@pytest.mark.parametrize(
    "n,d,q,r,h",
    [(20_011, 128, 300, 48, 512), (901, 33, 64, 13, 1), (3001, 960, 64, 64, 512),
     (2000, 128, 300, 1, 8)],
)
def test_search_expand_kernel_filter(dev, precision, masked, w, n, d, q, r, h):
    """The filter variant: `allowed` exactly the plain version's; ids,
    dists and fresh bitwise those of the same launch without the filter."""
    g = torch.Generator(dev).manual_seed(n + w)
    data, scale, offset = _store(torch.randn((n, d), generator=g, device=dev), precision)
    queries = torch.randn((q, d), generator=g, device=dev)
    nbrs = torch.randint(-1, n, (q, r), generator=g, device=dev, dtype=torch.int32)
    table = torch.full((q, h), -1, dtype=torch.int32, device=dev)
    if h > 1:
        _table_insert(table, nbrs[:, : r // 2])
    valid = (torch.rand((n,), generator=g, device=dev) > 0.3) if masked else None
    n_labels = 32 * w  # label 31, 63, ... sit on the int32 sign bit
    vwords = pack_ids(torch.randint(-1, n_labels, (n,), generator=g, device=dev), n_labels)
    fwords = random_query_filters(g, q, n_labels, 0.3)
    name = "search_expand" + ("" if precision == "fp32" else "/" + precision)
    name += "+valid" if masked else ""
    got = _launched(
        name + "+filter",
        lambda: search_expand(data, queries, nbrs, table, valid, scale, offset, vwords, fwords),
    )
    want = ref.search_expand_ref(data, queries, nbrs, table, valid, scale, offset, vwords, fwords)
    plain = search_expand(data, queries, nbrs, table, valid, scale, offset)
    assert len(got) == 4 and torch.equal(got[3], want[3])
    assert 0 < int(got[3].sum()) < int((got[0] >= 0).sum())  # both outcomes occur
    for a, b in zip(got[:3], plain):
        assert torch.equal(a, b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)


def test_filtered_tiered_and_layout_paths_on_the_card(dev):
    """Filtered search launches the filter variant; the host rescore tier
    equals the device tier bitwise, and the layout pass equals the plain
    index bitwise (dense visited), on the card; the labeled dynamic index
    at tier="host" with a layout equals the device tier through insert,
    delete and compact."""
    g = torch.Generator(dev).manual_seed(8)
    x = synthetic.make_preset(g, "sift-like", 5000)
    queries = synthetic.queries_from(g, x, 200)
    cfg = GRNNDConfig(s=12, r=24, t1=3, t2=3, pairs_per_vertex=24)
    pool = build_graph(x[:4500], cfg, draws=Draws(6, dev), device=dev)
    store = encode(x[:4500], "int8")
    labels = torch.randint(0, 40, (5000,), generator=g, device=dev)
    lstore = encode_labels(labels[:4500], 40)
    fw = random_query_filters(g, 200, 40, 0.1)
    kw = dict(k=10, ef=48, labels=lstore, filter=fw, device=dev)
    ops.reset_launch_counts()
    dev_tier = search(store, pool.ids, queries, rescore=x[:4500], **kw)
    assert ops.launch_counts().get("search_expand/int8+filter", 0) > 0
    host = HostTier(x[:4500])
    assert host.data.is_pinned() and host.device_bytes() == 0
    host_tier = search(store, pool.ids, queries, rescore=host, **kw)
    for a, b in zip(dev_tier, host_tier):
        assert torch.equal(a, b)
    assert predicate_fraction(host_tier.ids, fw, lstore.words) == 1.0
    opt = optimize(store, pool, order="bfs", rescore=x[:4500], labels=lstore, device=dev)
    for f in (None, fw):
        plain = search(store, pool.ids, queries, k=10, ef=48, rescore=x[:4500], labels=lstore,
                       filter=f, device=dev)
        laid = opt.search(queries, k=10, ef=48, filter=f)
        for a, b in zip(plain, laid):
            assert torch.equal(a, b)

    out = []
    for tier in ("device", "host"):
        dcfg = DynamicConfig(seed_k=8, seed_ef=48, precision="int8", tier=tier, layout="bfs")
        idx = DynamicIndex(
            x[:4500], pool, dcfg, draws=Draws(7, dev), device=dev,
            vertex_labels=labels[:4500], n_labels=40,
        )
        idx.insert(x[4500:], vertex_labels=labels[4500:])
        idx.delete(torch.arange(0, 5000, 9, device=dev))
        idx.compact()
        res = idx.search(queries, k=10, ef=48, filter=fw)
        out.append(res)
    assert idx.x.device.type == "cpu" and idx.x.is_pinned()
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert not torch.isin(out[1].ids, torch.arange(0, 5000, 9, device=dev)).any()


# bucket sizes of the engine tests: every power-of-two bucket from 1 to 64,
# most of them padded
ENGINE_GROUPS = (1, 2, 3, 5, 8, 13, 21, 33, 64)


@pytest.mark.parametrize(
    "case", ["fp32-hashed", "int8-rescore", "bf16-rescore", "int8-host", "filtered"]
)
def test_engine_on_the_card_is_bitwise_direct_search(dev, case):
    """The engine's batches, padded into buckets of 1 to 64 rows, give every
    request the ids and dists of a Q = 1 search and of one batched search
    of every request, on the card (Q-composition invariance)."""
    from repro_torch.serve import ann_engine as AE

    g = torch.Generator(dev).manual_seed(12)
    x = synthetic.make_preset(g, "sift-like", 5000)
    nq = sum(ENGINE_GROUPS)
    queries = synthetic.queries_from(g, x, nq)
    pool = build_graph(x, GRNNDConfig(s=12, r=24, t1=3, t2=3, pairs_per_vertex=24),
                       draws=Draws(13, dev), device=dev)
    kw = dict(visited="hashed", rescore=None)
    xt = x
    if case != "fp32-hashed" and case != "filtered":
        xt = encode(x, case[:4])
        kw = dict(visited="dense", rescore=HostTier(x) if case == "int8-host" else x)
    labels = encode_labels(torch.randint(0, 40, (5000,), generator=g, device=dev), 40)
    fw = random_query_filters(g, nq, 40, 0.1) if case == "filtered" else None
    entry = medoid(xt)
    worker = AE.StaticWorker(xt, pool.ids, entry=entry, labels=labels, device=dev, **kw)
    eng = AE.AnnEngine(worker, AE.EngineConfig(ef_menu=(64,), max_batch=64))
    q_np = queries.cpu().numpy()
    f_np = None if fw is None else fw.cpu().numpy()
    rids, lo = [], 0
    for size in ENGINE_GROUPS:
        for i in range(lo, lo + size):
            rids.append(eng.submit(q_np[i], k=10, ef=64,
                                   filter_words=None if f_np is None else f_np[i]))
        eng.run()
        lo += size
    assert sorted({e[1][0] for e in eng.log}) == [1, 2, 4, 8, 16, 32, 64]
    got = [eng.take_result(r) for r in rids]
    skw = dict(k=16, ef=64, entry=entry, labels=labels, overfetch=1, device=dev, **kw)
    batched = search(xt, pool.ids, queries, filter=fw, **skw)
    for i in range(nq):
        one = search(xt, pool.ids, queries[i : i + 1],
                     filter=None if fw is None else fw[i : i + 1], **skw)
        for res in (one, batched):
            j = 0 if res is one else i
            assert np.array_equal(got[i].ids, res.ids[j, :10].cpu().numpy()), (case, i)
            assert np.array_equal(got[i].dists, res.dists[j, :10].cpu().numpy()), (case, i)
    if fw is not None:
        ids = torch.from_numpy(np.stack([r.ids for r in got])).to(dev)
        assert predicate_fraction(ids, fw, labels.words) == 1.0


def test_dynamic_engine_on_the_card_matches_twin_index(dev):
    """An int8 index serving through the engine with churn (insert, then
    delete_oldest, between query batches) equals a twin index given the
    same mutations directly, each query batch searched at its real rows:
    results, pools, labels and validity bitwise (the dynamic index is
    deterministic on the card)."""
    from repro_torch.serve import ann_engine as AE

    g = torch.Generator(dev).manual_seed(14)
    x = synthetic.make_preset(g, "sift-like", 5000)
    queries = synthetic.queries_from(g, x, 96)
    pool = build_graph(x[:4500], GRNNDConfig(s=12, r=24, t1=3, t2=3, pairs_per_vertex=24),
                       draws=Draws(15, dev), device=dev)
    dcfg = DynamicConfig(seed_k=8, seed_ef=48, refine_rounds=2, pairs_per_vertex=24,
                         precision="int8")
    idx, twin = (DynamicIndex(x[:4500], pool, dcfg, draws=Draws(16, dev), device=dev)
                 for _ in range(2))
    eng = AE.AnnEngine(AE.DynamicWorker(idx, visited="hashed"),
                       AE.EngineConfig(ef_menu=(64,), max_batch=20, query_quantum=1))
    q_np = queries.cpu().numpy()
    rids = [eng.submit(q_np[i], k=10, ef=64) for i in range(96)]
    for b in range(4):
        eng.submit_insert(x[4500 + 125 * b : 4625 + 125 * b].cpu().numpy())
        eng.submit_delete_oldest(125)
    eng.run()
    got = [eng.take_result(r) for r in rids]
    lo = inserted = 0
    for kind, key, n in eng.log:
        if kind == "query":
            res = twin.search(queries[lo : lo + n], k=16, ef=64, visited="hashed", overfetch=1)
            for j in range(n):
                assert np.array_equal(got[lo + j].ids, res.ids[j, :10].cpu().numpy())
                assert np.array_equal(got[lo + j].dists, res.dists[j, :10].cpu().numpy())
            lo += n
        elif key == "insert":
            twin.insert(x[4500 + inserted : 4500 + inserted + n])
            inserted += n
        else:
            twin.delete(twin.oldest_live(n))
    assert lo == 96 and inserted == 500
    assert torch.equal(idx.pool.ids, twin.pool.ids) and torch.equal(idx.pool.dists, twin.pool.dists)
    assert torch.equal(idx.labels, twin.labels) and torch.equal(idx.valid, twin.valid)


KNN_D = 1152  # gemma3-1b's hidden width: the kNN-LM datastore's rows


def _round_inputs(dev, precision, n, d, c, r, p):
    g = torch.Generator(dev).manual_seed(n + d + r)
    data, scale, offset = _store(synthetic.vector_dataset(g, n, d), precision)
    ids = torch.randint(0, n, (c, r), generator=g, device=dev, dtype=torch.int32)
    ids[torch.rand((c, r), generator=g, device=dev) < 0.2] = -1
    dists = torch.rand((c, r), generator=g, device=dev) * 2 * d
    dists = torch.where(ids >= 0, dists, torch.inf)
    si = torch.randint(0, r, (c, p), generator=g, device=dev, dtype=torch.int32)
    sj = torch.randint(0, r, (c, p), generator=g, device=dev, dtype=torch.int32)
    return data, ids, dists, si, sj, scale, offset


def test_rng_round_kernel_raises_past_its_shared_memory(dev):
    """64 fp32 rows of 1152 (295 KB) do not fit a block: the wrapper takes
    the direct-read path (no fallback, counted as `rng_round+direct`) and
    agrees with the plain version; it raises only where even the index ring
    and the scale / offset outgrow shared memory."""
    args = _round_inputs(dev, "fp32", 3000, KNN_D, 500, 64, 64)
    got = _launched("rng_round+direct", lambda: rng_round(*args))
    want = ref.rng_round_ref(*args)
    torch.testing.assert_close(got[2], want[2], rtol=RTOL, atol=ATOL)
    assert torch.equal(got[1], want[1])
    d = 32_000  # 2 x 128 KB of fp32 scale / offset
    x = torch.zeros((4, d), dtype=torch.int8, device=dev)
    ids = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    ones = torch.ones((d,), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        rng_round(x, ids, torch.zeros((2, 4), device=dev), ids, ids, ones, ones)


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("n,d,c,r,p", [(6000, 128, 5000, 48, 48), (900, 33, 800, 12, 16),
                                       (3000, 1152, 2000, 24, 24)])
def test_rng_round_direct_path_is_bitwise_the_staged_path(dev, precision, n, d, c, r, p):
    args = _round_inputs(dev, precision, n, d, c, r, p)
    name = "rng_round" + ("" if precision == "fp32" else "/" + precision)
    staged = _launched(name, lambda: rng_round(*args))
    direct = _launched(name + "+direct", lambda: rng_round(*args, _direct=True))
    for a, b in zip(staged, direct):
        assert torch.equal(a, b)


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("d", [3584, 4096])
def test_rng_round_direct_path_past_shared_memory_matches_plain(dev, precision, d):
    """R = P = 24 at zamba2-7b's and qwen3-moe's widths: fp32 rows do not
    fit (the direct path runs unforced); bf16 and int8 are forced."""
    args = _round_inputs(dev, precision, 4000, d, 1500, 24, 24)
    name = "rng_round" + ("" if precision == "fp32" else "/" + precision) + "+direct"
    got = _launched(name, lambda: rng_round(*args, _direct=precision != "fp32"))
    want = ref.rng_round_ref(*args)
    torch.testing.assert_close(got[2], want[2], rtol=RTOL, atol=ATOL)
    assert torch.equal(got[1], want[1])
    data, ids, dists, si, sj = args[:5]
    thr = torch.maximum(dists.gather(1, si.long()), dists.gather(1, sj.long()))
    near = (want[2] - thr).abs() <= ATOL + RTOL * thr.abs()
    assert not ((got[0] != want[0]) & ~near).any()
    assert not ((got[3] != want[3]).any(1) & ~near.any(1)).any()


def test_moe_block_on_the_card_repeats_bitwise(dev):
    """deepseek-moe-16b's expert shapes (E = 64, top-6, d_expert 1408, two
    shared experts) at T = 4,096 bf16 tokens with drops: two calls give the
    same bits, and the output is finite."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as M

    cfg = get_arch("deepseek-moe-16b")
    gen = torch.Generator(dev).manual_seed(13)
    params = M.init_moe_params(gen, cfg, dtype=torch.bfloat16)
    x = torch.randn((4, 1024, cfg.d_model), generator=gen, device=dev).bfloat16()
    first, aux = M.moe_block(params, cfg, x)
    for _ in range(2):
        again, aux2 = M.moe_block(params, cfg, x)
        assert torch.equal(first, again)
        assert float(aux2["moe_drop_frac"]) == float(aux["moe_drop_frac"])
    assert bool(torch.isfinite(first).all())


def test_ssd_chunked_on_the_card_matches_the_recurrence(dev):
    """zamba2-7b's heads (nh 112, hd 64, st 64) at chunk 128, fp32, TF32 off."""
    from repro_torch.models import ssm as S

    g = torch.Generator(dev).manual_seed(14)
    b, s, nh, hd, st = 2, 256, 112, 64, 64
    xh = torch.randn((b, s, nh, hd), generator=g, device=dev)
    a = torch.sigmoid(torch.randn((b, s, nh), generator=g, device=dev) + 1.0)
    bb = torch.randn((b, s, st), generator=g, device=dev)
    cc = torch.randn((b, s, st), generator=g, device=dev)
    h0 = torch.randn((b, nh, hd, st), generator=g, device=dev)
    y, h = S._ssd_chunked(xh, a, bb, cc, h0, 128)
    ny, nh_ = S.ssd_naive(xh, a, bb, cc, h0)
    torch.testing.assert_close(y, ny, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, nh_, rtol=1e-4, atol=1e-4)


def test_knn_vote_is_deterministic_on_the_card(dev):
    """Rows full of repeated tokens at vocab 262,144: the vote is bitwise
    the same in every call (no float atomics), and within fp32 rounding of
    the CPU's."""
    from repro_torch.retrieval import knn_lm

    g = torch.Generator(dev).manual_seed(11)
    q, k, vocab = 512, 8, 262_144
    ids = torch.randint(-1, 1000, (q, k), generator=g, device=dev)
    dists = torch.rand((q, k), generator=g, device=dev) * 40
    toks = torch.randint(0, 3, (q, k), generator=g, device=dev, dtype=torch.int32)
    first = knn_lm.vote_log_probs(ids, dists, toks, vocab)
    for _ in range(5):
        assert torch.equal(knn_lm.vote_log_probs(ids, dists, toks, vocab), first)
    cpu = knn_lm.vote_log_probs(ids.cpu(), dists.cpu(), toks.cpu(), vocab)
    assert torch.equal(torch.isneginf(first).cpu(), torch.isneginf(cpu))
    fin = torch.isfinite(cpu)
    torch.testing.assert_close(first.cpu()[fin], cpu[fin], rtol=1e-5, atol=1e-6)


def test_fp32_knn_datastore_on_the_card_is_the_array_path(dev):
    """At D = 1152: the fp32 `DynamicDatastore`'s retrieval bitwise
    `knn_logits` on the array-backed store pinned to the same entry and
    validity view, and the engine-routed retrieval bitwise the direct one."""
    from repro_torch.retrieval import knn_lm

    g = torch.Generator(dev).manual_seed(12)
    n, vocab = 4000, 262_144
    x = synthetic.vector_dataset(g, n, KNN_D)
    toks = torch.randint(0, vocab, (n,), generator=g, device=dev, dtype=torch.int32)
    q = x[:300] + 0.05 * torch.randn((300, KNN_D), generator=g, device=dev)
    for visited in ("dense", "hashed"):
        ds = knn_lm.DynamicDatastore.build(x, toks, vocab, precision="fp32", draws=Draws(3, dev),
                                           device=dev, visited=visited)
        store = knn_lm.build_datastore(x, toks, draws=Draws(3, dev), device=dev)
        assert torch.equal(store.graph, ds.index.pool.ids[:n])
        got = ds.knn_log_probs(q)
        want = knn_lm.knn_logits(store, q, vocab, entry=ds.index.entry(),
                                 valid=ds.index.valid[:n], visited=visited)
        assert torch.equal(got, want)
        ds.attach_engine()
        assert torch.equal(ds.knn_log_probs(q), got)


# ---------------------------------------------------------------------------
# training (no kernel of its own: the LM stack's autograd on the card)
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("gemma2-2b", "h2o-danube-1.8b", "gemma3-27b", "gemma3-1b", "deepseek-moe-16b",
               "qwen3-moe-235b-a22b", "musicgen-large", "mamba2-130m", "zamba2-7b",
               "internvl2-2b")


@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_training_step_on_the_card_matches_the_cpu_port(dev, name):
    """One training step a family at reduced() width, fp32 activations: the
    loss within 1e-4 and each gradient leaf within 1e-3 of the largest
    magnitude of the CPU port's leaf (10x the CPU tests' tolerances
    against JAX: two devices' summation orders and transcendentals), from
    the same parameters and pipeline batch."""
    from repro_torch import convert
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import pipeline as PIPE
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS

    cfg = reduced(get_arch(name))
    host = T.init_params(cfg, seed=5, device="cpu")
    card = convert.lm_params_from_jax(convert.lm_params_to_jax(host, cfg), cfg, device=dev)
    batch = PIPE.batch_for_step(cfg, 0, 2, 64, device="cpu")
    loss_h, _, grads_h = TS.loss_and_grads(host, cfg, batch, act_dtype=torch.float32)
    loss_c, _, grads_c = TS.loss_and_grads(card, cfg, {k: v.to(dev) for k, v in batch.items()},
                                           act_dtype=torch.float32)
    assert abs(float(loss_c) - float(loss_h)) <= 1e-4
    for n, g in grads_h.items():
        assert bool(torch.isfinite(grads_c[n]).all()), n
        scale = float(g.abs().max())
        assert float((grads_c[n].cpu() - g).abs().max()) <= 1e-3 * scale + 1e-12, n


def test_resumed_training_on_the_card_is_bitwise(dev, tmp_path, monkeypatch):
    """gemma3-1b reduced, 6 steps straight against 3 steps, a checkpoint,
    a restore into a fresh state and 3 more, under
    `torch.use_deterministic_algorithms` (the embedding's backward
    scatter-adds into repeated Zipf rows): every parameter bitwise."""
    from repro_torch.launch import train as LT

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        kw = dict(steps=6, batch=4, seq=64, save_every=3, act_dtype=torch.bfloat16, device=dev)
        a, _ = LT.train("gemma3-1b", ckpt_dir=str(tmp_path / "a"), **kw)
        LT.train("gemma3-1b", stop_at=3, ckpt_dir=str(tmp_path / "b"), **kw)
        b, _ = LT.train("gemma3-1b", ckpt_dir=str(tmp_path / "b"), **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    assert int(a.opt.step) == int(b.opt.step) == 6
    for (n, x), (_, y) in zip(a.params.named_parameters(), b.params.named_parameters()):
        assert torch.equal(x, y), n
    for n, x in a.opt.mu.items():
        assert torch.equal(x, b.opt.mu[n]) and torch.equal(a.opt.nu[n], b.opt.nu[n]), n


def _sync_warnings(fn):
    """(fn(), the synchronizing operations it ran) under
    `torch.cuda.set_sync_debug_mode("warn")`, each warning kept."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [w for w in caught if "called a synchronizing" in str(w.message)]


def _counted_syncs(fn):
    """(fn(), its sync warnings, the passes of each counted sync site)."""
    before = trace.counts()
    out, warned = _sync_warnings(fn)
    after = trace.counts()
    return out, warned, {k[len("host_sync/"):]: after[k] - before[k] for k in after
                         if k.startswith("host_sync/")}


@pytest.mark.parametrize("budget", [None, 20_000])
def test_build_and_hashed_search_sync_only_at_counted_sites(dev, monkeypatch, budget):
    """A build and a hashed search wait for the card exactly as often as
    their counted sync sites (`trace.SYNCS`) are passed: once a
    reverse-edge round, once a staging (its active requests counted), and
    once more a sliced staging (a forced budget of 20,000 under the active
    requests of each staging of 240,000: 13-42% of them active on the CPU).
    A search drains the stream once, at its entry's gather; the frontier's
    wait, once a loop iteration, is an event wait on the test one iteration
    back, which leaves the stream queued, and the loop runs one spare step."""
    g = torch.Generator(dev).manual_seed(3)
    x = synthetic.make_preset(g, "sift-like", 10_000)
    queries = synthetic.queries_from(g, x, 200)
    cfg = GRNNDConfig(s=12, r=24, t1=3, t2=3, pairs_per_vertex=24, chunk_size=1000)
    draws = Draws(1, dev)
    if budget is not None:
        monkeypatch.setattr(pools, "STAGE_BUDGET", budget)
    bounds, sliced = pools._slice_bounds, []
    monkeypatch.setattr(pools, "_slice_bounds", lambda *a: sliced.append(1) or bounds(*a))
    pool, warned, passes = _counted_syncs(lambda: build_graph(x, cfg, draws=draws, device=dev))
    where = sorted({(w.filename, w.lineno) for w in warned})
    assert passes["grnnd.reverse"] == cfg.t1 - 1
    stagings = cfg.t1 * cfg.t2 + cfg.t1 - 1
    # every staging: the active count read; sliced (each one past the forced
    # budget), the ranges read too
    assert len(sliced) == (0 if budget is None else stagings)
    assert passes["pools.stage"] == stagings + len(sliced)
    assert len(warned) == sum(passes.values()), where
    before = trace.counts()
    res, warned, passes = _counted_syncs(
        lambda: search(x, pool.ids, queries, k=10, ef=48, visited="hashed", device=dev)
    )
    after = trace.counts()
    where = sorted({(w.filename, w.lineno) for w in warned})
    expands = after["launch/search_expand"] - before.get("launch/search_expand", 0)
    assert passes["search.frontier"] == expands + 1 > 1
    assert after["search/spare_steps"] - before["search/spare_steps"] == 1
    assert passes["search.entry"] == 1 and passes["grnnd.reverse"] == 0
    assert len(warned) == passes["search.entry"], (passes, where)
    assert int(res.n_expanded.min()) > 0


def test_sliced_staging_on_the_card_is_bitwise_the_one_pass(dev, monkeypatch):
    """At 2·10^6 rows (DEEP1M's build settings, the deep-like preset) a build
    whose every staging of 9.6·10^7 requests runs in slices of at most 2^22
    is bitwise the build that stages each in one pass."""
    g = torch.Generator(dev).manual_seed(6)
    x = synthetic.make_preset(g, "deep-like", 2_000_000)
    cfg = GRNNDConfig(s=24, r=48, t1=3, t2=6, rho=0.6, pairs_per_vertex=48, chunk_size=4096)
    want = build_graph(x, cfg, draws=Draws(2, dev), device=dev)
    monkeypatch.setattr(pools, "STAGE_BUDGET", 1 << 22)
    before = trace.counts()["pools/slices"]
    got = build_graph(x, cfg, draws=Draws(2, dev), device=dev)
    torch.cuda.synchronize()
    assert torch.equal(got.ids, want.ids) and torch.equal(got.dists, want.dists)
    # a round's active requests (its redirects) and a reverse round's, past 2^22
    assert trace.counts()["pools/slices"] - before > 2 * (cfg.t1 * cfg.t2 + cfg.t1 - 1)


def test_staging_on_the_card_is_bitwise_the_uncompacted_one_pass(dev, monkeypatch):
    """At 2·10^5 rows of the sift-like preset and the paper's SIFT1M
    settings, each staging of a build (24 rounds' redirects, 3 reverse
    rounds' requests, 9.6·10^6 a round) stages its active requests alone
    bitwise as the whole batch in one pass; ~5-50% of them are active."""
    g = torch.Generator(dev).manual_seed(7)
    x = synthetic.make_preset(g, "sift-like", 200_000)
    cfg = SIFT1M.build
    stage, seen = pools._stage, []

    def held(dst, src, dist, n, cap, drop_self=True, budget=None):
        got = stage(dst, src, dist, n, cap, drop_self, budget)
        want = one_pass(dst, src, dist, n, cap, drop_self)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        seen.append((dst.shape[0], int(active(dst, src, drop_self).sum())))
        return got

    monkeypatch.setattr(pools, "_stage", held)
    before = trace.counts()
    build_graph(x, cfg, draws=Draws(5, dev), device=dev)
    after = trace.counts()
    assert len(seen) == cfg.t1 * cfg.t2 + cfg.t1 - 1
    requests, act = (after[k] - before[k] for k in ("pools/requests", "pools/active"))
    assert (requests, act) == tuple(map(sum, zip(*seen)))
    assert all(0 < a < m for m, a in seen)
    assert 0.05 <= act / requests <= 0.5


def test_beam_merge_carries_the_flags_once_a_step(dev):
    """A hashed unfiltered search without a rescore launches the flagged
    merge once a step (as often as B3) and the plain merge never; a build
    launches only the plain merge: the init, each round and each
    reverse-edge round."""
    g = torch.Generator(dev).manual_seed(4)
    x = synthetic.make_preset(g, "sift-like", 4000)
    queries = synthetic.queries_from(g, x, 200)
    cfg = GRNNDConfig(s=12, r=24, t1=3, t2=3, pairs_per_vertex=24)

    def launched(fn):
        before = trace.counts()
        out = fn()
        torch.cuda.synchronize()
        after = trace.counts()
        return out, {k: v - before.get(k, 0) for k, v in after.items() if k.startswith("launch/")}

    pool, built = launched(lambda: build_graph(x, cfg, draws=Draws(1, dev), device=dev))
    assert built.get("launch/topr_merge/flags", 0) == 0
    assert built["launch/topr_merge"] == 1 + cfg.t1 * cfg.t2 + cfg.t1 - 1
    _, searched = launched(
        lambda: search(x, pool.ids, queries, k=10, ef=48, visited="hashed", device=dev)
    )
    assert searched["launch/topr_merge/flags"] == searched["launch/search_expand"] > 1
    assert searched.get("launch/topr_merge", 0) == 0
