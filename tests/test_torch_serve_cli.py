"""repro_torch.launch.serve, the port's serving CLI, on the CPU.

The index file is the reference's format (`np.savez_compressed` of `ids`,
`dists` and `x`), written from a `repro.core.build_graph` pool over the
`tiny` preset, so the port serves an index the reference built:

  * every mode runs in process (`main([...])`) and its stats line parses
    (each field a number, or one of the named words);
  * filtered serving: `pred_ok` exactly 1.0 and recall@10 >= 0.9, the
    reference's bar (`tests/test_serving.py`); under `--mutable` too;
  * `--corpus-shards 2`: recall@10 >= 0.85, and ids and dists bitwise the
    replicated run's;
  * `--engine`: every request completes, p50 <= p99;
  * every argparse rejection of the reference raises SystemExit;
  * across processes: `python -m repro_torch.launch.serve` reads the file;
    under `torchrun --nproc-per-node 2` on gloo, `--shards 2`, `--shards 1`
    and `--corpus-shards 2` give the ids and dists of one process;
    `build_index --sharded` under `torchrun` at 2 ranks reaches recall@10
    within 0.02 of the unsharded build (other draws);
  * `examples/serve_ann_torch.py --device cpu` runs at a small n.
"""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import grnnd as jgrnnd
from repro.data import synthetic as jsynthetic
from repro_torch.launch import build_index, serve

# the suite runs in parallel workers: one intra-op thread each keeps torch
# from oversubscribing the cores the JAX tests share
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N = 512
BASE = ["--device", "cpu", "--batches", "2", "--batch-size", "32", "--ef", "32"]
WORDS = {"backend", "visited", "precision", "tier", "opt_layout", "device"}
# the modes of the CLI; each line's recall floor (the graph reads ~0.95+ at ef 32)
MODES = {
    "static": ([], 0.85),
    "hashed": (["--visited", "hashed"], 0.85),
    "filtered": (["--filter-labels", "20", "--selectivity", "0.5"], 0.9),
    "int8-host": (["--precision", "int8", "--tier", "host"], 0.85),
    "bf16-norescore": (["--precision", "bf16", "--no-rescore"], 0.8),
    "layout": (["--optimize-layout", "bfs"], 0.85),
    "corpus": (["--corpus-shards", "2"], 0.85),
    "shards1": (["--shards", "1"], 0.85),
    "mutable": (["--mutable", "--churn", "16"], 0.8),
    "mutable-filtered": (["--mutable", "--churn", "8", "--filter-labels", "20",
                          "--selectivity", "0.5"], 0.8),
    "engine": (["--engine", "--requests", "64", "--visited", "hashed"], 0.85),
    "engine-filtered": (["--engine", "--requests", "48", "--filter-labels", "20",
                         "--mix-ef", "32,48"], 0.85),
    "engine-mutable": (["--engine", "--mutable", "--requests", "48", "--churn-every", "16"],
                       None),
}


def fields(line: str) -> dict:
    """The stats line's `name=value` fields; numbers parsed (a trailing
    "ms" dropped), the named words as they are."""
    out = {}
    for name, value in re.findall(r"(\S+)=(\S+)", line):
        if name in WORDS:
            out[name] = value
        else:
            out[name] = float(value[:-2] if value.endswith("ms") else value)
    return out


@pytest.fixture(scope="module")
def index_file(tmp_path_factory):
    key = jax.random.PRNGKey(0)
    x = jsynthetic.make_preset(key, "tiny", N)
    pool = jgrnnd.build_graph(jax.random.PRNGKey(1), x,
                              jgrnnd.GRNNDConfig(s=8, r=16, t1=2, t2=3, pairs_per_vertex=16))
    path = tmp_path_factory.mktemp("serve") / "tiny.idx.npz"
    np.savez_compressed(path, ids=np.asarray(pool.ids), dists=np.asarray(pool.dists),
                        x=np.asarray(x))
    return str(path)


def run(index_file, *extra) -> dict:
    return serve.main(["--index", index_file, *BASE, *extra])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_runs_and_its_stats_line_parses(index_file, mode, capsys):
    extra, floor = MODES[mode]
    out = run(index_file, *extra)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == out["line"]
    f = fields(line)
    assert f["device"] == "cpu" and f["backend"] == "ref"
    assert f["qps"] > 0 and f["p50"] > 0
    recall = f.get("recall@10", f.get("recall"))
    if floor is not None:
        assert recall >= floor, line
    if "pred_ok" in f:
        assert f["pred_ok"] == 1.0 and out["pred_ok"] == 1.0, line
    if "--engine" in extra:
        assert f["engine"] == 1 and f["completed"] == out["n_completed"] > 0
        assert f["rejected"] == 0 and f["p50"] <= f["p99"]
        assert out["n_completed"] == int(extra[extra.index("--requests") + 1])
    else:
        assert out["ids"].shape == (2, 32, 10)


def test_filtered_serving_raises_ef_to_the_overfetch_floor(index_file):
    out = run(index_file, "--filter-labels", "20", "--selectivity", "0.5", "--k", "5")
    assert out["ef"] == 40  # ceil(4 k / s)
    assert out["pred_ok"] == 1.0 and out["recall"] >= 0.9


def test_corpus_shards_are_bitwise_the_replicated_run(index_file):
    plain = run(index_file, "--visited", "hashed")
    for s in ("2", "3"):
        sharded = run(index_file, "--visited", "hashed", "--corpus-shards", s)
        np.testing.assert_array_equal(sharded["ids"], plain["ids"])
        np.testing.assert_array_equal(sharded["dists"], plain["dists"])
        assert sharded["recall"] >= 0.85


REJECTED = [
    ["--visited-cap", "64"],
    ["--shards", "2"],
    ["--shards", "1", "--mutable"],
    ["--corpus-shards", "2", "--shards", "1"],
    ["--corpus-shards", "2", "--mutable"],
    ["--churn", "4"],
    ["--refine-rounds", "1"],
    ["--no-rescore"],
    ["--tier", "host"],
    ["--tier", "host", "--precision", "int8", "--no-rescore"],
    ["--selectivity", "0.1"],
    ["--filter-labels", "10", "--selectivity", "1.5"],
    ["--engine", "--shards", "1"],
    ["--offered-qps", "10"],
    ["--mix-ef", "32"],
    ["--engine", "--mutable", "--corpus-shards", "2"],
    ["--engine", "--mix-k", "40"],
]


@pytest.mark.parametrize("extra", REJECTED, ids=[" ".join(e) for e in REJECTED])
def test_rejections(index_file, extra):
    with pytest.raises(SystemExit) as err:
        run(index_file, *extra)
    assert err.value.code not in (0, None)


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


def _last_line(proc) -> str:
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return [ln for ln in proc.stdout.splitlines() if "qps=" in ln or "built" in ln][-1]


def test_serve_across_a_process_boundary(index_file):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--index", index_file, *BASE,
         "--filter-labels", "20", "--selectivity", "0.5"],
        env=_env(), capture_output=True, text=True, timeout=300,
    )
    f = fields(_last_line(proc))
    assert f["pred_ok"] == 1.0 and f["recall@10"] >= 0.9 and f["device"] == "cpu"


def _torchrun(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         *args],
        env=_env(), capture_output=True, text=True, timeout=timeout,
    )


RANKS = [["--shards", "2"], ["--shards", "1"], ["--corpus-shards", "2"]]
# one rank of the torchrun runs: the serving CLI's `main`, and rank 0 saves
# the ids and dists it returns
RANK_SCRIPT = """
import os, sys
import numpy as np
from repro_torch.launch import serve
out = serve.main(sys.argv[2:])
if os.environ["RANK"] == "0":
    np.savez(sys.argv[1], ids=out["ids"], dists=out["dists"])
"""


@pytest.mark.parametrize("extra", RANKS, ids=[" ".join(e) for e in RANKS])
def test_ranks_on_gloo_equal_one_process(index_file, tmp_path, extra):
    """Under torchrun at 2 gloo ranks: the queries over both ranks, over
    the first rank alone (the other sits out), or the corpus's two shards
    one a rank; rank 0's results are the one-process run's, bitwise."""
    script, out = tmp_path / "rank.py", tmp_path / "ranks.npz"
    script.write_text(RANK_SCRIPT)
    proc = _torchrun(str(script), str(out), "--index", index_file, *BASE,
                     "--visited", "hashed", *extra)
    f = fields(_last_line(proc))
    assert (f["shards"], f["corpus_shards"]) == (
        (int(extra[1]), 1) if extra[0] == "--shards" else (1, 2)
    )
    assert proc.stdout.count("qps=") == 1  # only rank 0 prints
    one = run(index_file, "--visited", "hashed")
    got = np.load(out)
    np.testing.assert_array_equal(got["ids"], one["ids"])
    np.testing.assert_array_equal(got["dists"], one["dists"])


def test_sharded_build_under_torchrun(tmp_path):
    plain = build_index.main(["--dataset", "sift-demo", "--out", str(tmp_path / "one.npz"),
                              "--device", "cpu"])
    proc = _torchrun("-m", "repro_torch.launch.build_index", "--dataset", "sift-demo",
                     "--out", str(tmp_path / "two.npz"), "--device", "cpu", "--sharded")
    line = _last_line(proc)
    assert "over 2 rank(s)" in line
    recall = float(re.search(r"recall@10=([\d.]+)", line).group(1))
    assert abs(recall - plain["recall_at_10"]) <= 0.02, (recall, plain["recall_at_10"])
    saved = np.load(tmp_path / "two.npz")
    assert saved["ids"].shape == (1500, 16)


def test_serve_ann_torch_example():
    spec = importlib.util.spec_from_file_location(
        "serve_ann_torch", ROOT / "examples" / "serve_ann_torch.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    stats = mod.main(["--device", "cpu", "--n", "2000", "--batches", "3", "--batch-size", "64"])
    assert stats["recall_at_10"] >= 0.9 and stats["qps"] > 0 and stats["degree"] > 0
