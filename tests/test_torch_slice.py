"""The port's whole path against the JAX path, and the port's boundaries.

  * data -> build -> search -> recall on the same numpy data, with the
    reference's draws: ground truth equal as sets (fp32 distance ties aside:
    at least 99.5% of the true neighbors agree), and recall@10 within 0.02
    of the JAX path (the graphs drift apart from the first fp32 near-tie on,
    so they are compared by the recall they reach);
  * the package imports neither JAX nor the JAX package;
  * entry points default to the card and raise without one (the build in
    every order, the corpus-sharded index, build and search, the
    distributed search and build, before any process group is asked for,
    the serving engine's static worker and the serving CLI, the LM's
    parameters and cache for every family, the parameter converter and
    `ServeEngine`, the kNN-LM datastores);
  * the launch CLI, `examples/quickstart_torch.py` and
    `examples/knn_lm_torch.py` run end to end on the CPU when asked to.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grnnd as jgrnnd
from repro.core import recall as jrecall
from repro.core.search import search as jsearch
from repro.data import synthetic as jsynthetic
from repro_torch import convert
from repro_torch.core import (
    GRNNDConfig,
    brute_force_knn,
    build_graph,
    distributed_search,
    recall_at_k,
    search,
    shard,
    sharded_build,
    sharded_build_graph,
    sharded_search,
)
from repro_torch.configs import get_arch, reduced
from repro_torch.launch import build_index, serve
from repro_torch.models import transformer as T
from repro_torch.retrieval import knn_lm
from repro_torch.serve import ServeEngine, StaticWorker
from test_torch_grnnd import jax_draws

# the suite runs in parallel workers: one intra-op thread each keeps torch
# from oversubscribing the cores the JAX tests share
torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"


def test_whole_path_matches_the_jax_path():
    n, nq = 2000, 100
    x = np.asarray(jsynthetic.make_preset(jax.random.PRNGKey(0), "sift-like", n))
    queries = np.asarray(jsynthetic.queries_from(jax.random.PRNGKey(1), jnp.asarray(x), nq))
    cfg = GRNNDConfig(s=12, r=24, t1=3, t2=3, rho=0.6, pairs_per_vertex=24)
    key = jax.random.PRNGKey(2)

    j_truth = jrecall.brute_force_knn(jnp.asarray(x), jnp.asarray(queries), 10)
    j_pool = jgrnnd.build_graph(key, jnp.asarray(x), jgrnnd.GRNNDConfig(**cfg._asdict()))
    jq = jnp.asarray(queries)
    j_res = jsearch(jnp.asarray(x), j_pool.ids, jq, k=10, ef=48, visited="hashed")
    j_recall = jrecall.recall_at_k(j_res.ids, j_truth)

    truth = brute_force_knn(x, queries, 10, device="cpu")
    assert truth.dtype == torch.int32 and truth.shape == (nq, 10)
    assert recall_at_k(truth, j_truth) >= 0.995
    pool = build_graph(x, cfg, draws=jax_draws(key, n, cfg), device="cpu")
    res = search(x, pool.ids, queries, k=10, ef=48, visited="hashed", device="cpu")
    got = recall_at_k(res.ids, truth)
    assert abs(got - j_recall) <= 0.02, (got, j_recall)
    assert got >= 0.8


def test_package_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))]\n"
        "bad += [m for m in sys.modules if m == 'repro']\n"
        "mods = sorted(m for m in sys.modules if m.startswith('repro_torch'))\n"
        "print(len(mods), bad, ' '.join(mods))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        env={**os.environ, "PYTHONPATH": str(SRC)},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 53  # every module was imported
    for mod in (
        "repro_torch.core.corpus_shard",
        "repro_torch.core.distributed",
        "repro_torch.serve",
        "repro_torch.serve.ann_engine",
        "repro_torch.launch.serve",
        "repro_torch.configs.gemma3_1b",
        "repro_torch.models.layers",
        "repro_torch.models.attention",
        "repro_torch.models.transformer",
        "repro_torch.models.moe",
        "repro_torch.models.ssm",
        "repro_torch.serve.engine",
        "repro_torch.retrieval",
        "repro_torch.retrieval.knn_lm",
    ):
        assert mod in out.stdout.split()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    x = np.zeros((20, 4), np.float32)
    ids = np.zeros((20, 2), np.int32)
    cfg = GRNNDConfig(s=2, r=2, t1=1, t2=1, pairs_per_vertex=2)
    lm_cfg = reduced(get_arch("gemma3-1b"))
    lm_params = T.init_params(lm_cfg, device="cpu")
    moe_cfg, ssm_cfg = reduced(get_arch("deepseek-moe-16b")), reduced(get_arch("zamba2-7b"))
    audio_cfg, vision_cfg = reduced(get_arch("musicgen-large")), reduced(get_arch("internvl2-2b"))
    audio_params = T.init_params(audio_cfg, device="cpu")
    calls = [
        lambda: build_graph(x, cfg),
        lambda: build_graph(x, cfg._replace(order="ascending")),
        lambda: shard(x, ids, 2),
        lambda: sharded_build(x, cfg, 2),
        lambda: sharded_search(shard(x, ids, 2), x[:2]),
        lambda: distributed_search(x, ids, x[:2]),
        lambda: sharded_build_graph(x, cfg),
        lambda: search(x, ids, x[:2]),
        lambda: brute_force_knn(x, x[:2], 3),
        lambda: convert.from_jax(ids, x[:, :2], x),
        lambda: build_index.main(["--dataset", "sift-demo", "--out", "unused.npz"]),
        lambda: build_index.main(["--dataset", "sift-demo", "--out", "unused.npz", "--sharded"]),
        lambda: StaticWorker(x, ids),
        lambda: serve.main(["--index", "unused.npz"]),
        lambda: serve.main(["--index", "unused.npz", "--engine"]),
        lambda: T.init_params(lm_cfg),
        lambda: T.make_cache(lm_cfg, 1, 8),
        lambda: convert.lm_params_from_jax({}, lm_cfg),
        lambda: ServeEngine(lm_cfg, lm_params, s_max=8),
        lambda: T.init_params(moe_cfg),
        lambda: T.init_params(ssm_cfg),
        lambda: T.init_params(audio_cfg),
        lambda: T.init_params(vision_cfg),
        lambda: T.make_cache(ssm_cfg, 1, 8),
        lambda: convert.lm_params_from_jax({}, ssm_cfg),
        lambda: ServeEngine(audio_cfg, audio_params, s_max=8),
        lambda: knn_lm.build_datastore(x, ids[:, 0]),
        lambda: knn_lm.DynamicDatastore.build(x, ids[:, 0], 8),
        lambda: knn_lm.DynamicDatastore.empty(4, 8),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_build_index_cli_on_the_cpu(tmp_path):
    out = tmp_path / "demo.npz"
    stats = build_index.main(["--dataset", "sift-demo", "--out", str(out), "--device", "cpu"])
    assert stats["recall_at_10"] >= 0.8 and stats["device"] == "cpu"
    saved = np.load(out)
    assert saved["ids"].shape == (1500, 16) and saved["x"].shape == (1500, 128)


def test_quickstart_torch_on_the_cpu():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", SRC.parent / "examples" / "quickstart_torch.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    stats = mod.main(["--device", "cpu", "--n", "2000"])
    assert stats["recall_at_10"] >= 0.8 and stats["degree"] > 0


def test_knn_lm_torch_example_on_the_cpu():
    spec = importlib.util.spec_from_file_location(
        "knn_lm_torch", SRC.parent / "examples" / "knn_lm_torch.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    stats = mod.main(["--device", "cpu", "--new-tokens", "8"])
    assert stats["pairs"] == 32 * 63 and stats["grew"] == 4 * 8
    assert stats["fused_nll"] < stats["pure_nll"] and stats["filtered_support"] == 1.0
