"""repro_torch.core.distributed on gloo at 2 and 4 ranks, on the CPU.

One module fixture per world size starts the ranks once
(`_torch_dist_worker.py`, rendezvous through a `file://` in `tmp_path`, one
intra-op thread a rank) and every rank runs every check; each test reads
one check's verdict from every rank. Bitwise (ids, dists and n_expanded,
or the whole pool):

  * `distributed_search` against the port's single-process `search`:
    unfiltered, filtered, hashed, int8 with the fp32 rescore and
    tombstones, the host rescore tier, `OptimizedIndex.distributed_search`,
    and 13 queries (not a multiple of the ranks);
  * `corpus_sharded_search` (`sharded_search(group=)`) against the
    in-process `sharded_search`: fp32, filtered and hashed, int8 with
    tombstones and the rescore, the host tier;
  * `sharded_apply_requests` against `insert_requests`, and a
    `DynamicIndex(group=)` against the in-process index over two insert
    batches (pools, labels, then a search);
  * `sharded_build_graph` with `comm="allgather"` and `"a2a"` (no bucket
    overflows, which the check asserts), that pool against the
    single-process `build_graph` fed the ranks' draws concatenated, and an
    ascending-order build against `build_graph`.

Against the reference's single-device `repro.core.search.search` (its
sharded search fails on this tree: ROADMAP C.1), on the reference's graph:
ids equal in at least 90% of queries, distances within rtol 1e-5 there.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import grnnd as jgrnnd
from repro.core import labels as JL
from repro.core import vecstore as JVS
from repro.core.search import search as jsearch
from repro.data import synthetic as jsynthetic

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
N, NQ, K, EF = 256, 12, 10, 32
WORLDS = (2, 4)
CHECKS = (
    "search-unfiltered",
    "search-filtered",
    "search-hashed",
    "search-int8-rescore",
    "search-host",
    "search-optimized",
    "search-odd-q",
    "corpus-fp32",
    "corpus-filtered-hashed",
    "corpus-int8-valid",
    "corpus-host",
    "apply-requests",
    "dynamic-insert",
    "build-allgather-a2a",
    "build-vs-single",
    "build-sorted",
)
QUERY_MATCH = 0.9


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    x = np.array(jsynthetic.make_preset(jax.random.PRNGKey(0), "tiny", N))
    jx = jnp.asarray(x)
    q = np.array(jsynthetic.queries_from(jax.random.PRNGKey(1), jx, NQ + 1))
    cfg = jgrnnd.GRNNDConfig(s=8, r=16, t1=2, t2=3, pairs_per_vertex=16)
    pool = jgrnnd.build_graph(jax.random.PRNGKey(2), jx, cfg)
    rng = np.random.default_rng(3)
    vlabels = rng.integers(0, 20, N).astype(np.int32)
    out = dict(
        x=x, q=q[:NQ], q13=q, ids=np.array(pool.ids), dists=np.array(pool.dists),
        vlabels=vlabels,
        fwords=np.asarray(JL.pack_ids(jnp.asarray(rng.integers(0, 20, NQ), jnp.int32), 20)),
        valid=rng.random(N) > 0.15,
    )
    path = tmp_path_factory.mktemp("dist") / "data.npz"
    np.savez(path, **out)
    return out, path


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def run(request, data, tmp_path_factory):
    """Every rank's verdicts (a list of dicts) and rank 0's arrays."""
    world = request.param
    out = tmp_path_factory.mktemp(f"world{world}")
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, str(HERE / "_torch_dist_worker.py"), str(r), str(world),
             str(out / "init"), str(data[1]), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for p2 in procs:
                p2.kill()
            pytest.fail(f"world {world}: a rank did not finish in 240 s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    verdicts = [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
    return world, verdicts, dict(np.load(out / "results.npz"))


@pytest.mark.parametrize("check", CHECKS)
def test_distributed_is_bitwise_the_single_process_path(run, check):
    world, verdicts, _ = run
    for rank, v in enumerate(verdicts):
        assert v[check] is True, f"world {world} rank {rank}: {v[check]}"


def _reference(d, mode):
    """The reference's single-device search of one mode, on its graph."""
    jx, ids = jnp.asarray(d["x"]), jnp.asarray(d["ids"])
    q = jnp.asarray(d["q"])
    if mode == "search-unfiltered":
        return jsearch(jx, ids, q, k=K, ef=EF)
    if mode == "search-filtered":
        labels = JL.encode_labels(jnp.asarray(d["vlabels"]), 20)
        return jsearch(jx, ids, q, k=K, ef=EF, labels=labels, filter=jnp.asarray(d["fwords"]))
    if mode == "search-hashed":
        return jsearch(jx, ids, q, k=K, ef=EF, visited="hashed", visited_cap=64)
    if mode == "search-int8-rescore":
        return jsearch(JVS.encode(jx, "int8"), ids, q, k=K, ef=EF, rescore=jx,
                       valid=jnp.asarray(d["valid"]))
    if mode == "search-odd-q":
        return jsearch(jx, ids, jnp.asarray(d["q13"]), k=K, ef=EF, visited="hashed")
    raise ValueError(mode)


@pytest.mark.parametrize(
    "mode",
    ("search-unfiltered", "search-filtered", "search-hashed", "search-int8-rescore",
     "search-odd-q"),
)
def test_distributed_search_matches_the_reference_search(run, data, mode):
    _, _, arrays = run
    want = _reference(data[0], mode)
    got_ids, got_d = arrays[f"{mode}/ids"], arrays[f"{mode}/dists"]
    same = (got_ids == np.asarray(want.ids)).all(1)
    assert same.mean() >= QUERY_MATCH, same.mean()
    np.testing.assert_allclose(got_d[same], np.asarray(want.dists)[same], rtol=1e-5)
