"""The plain reference at a tiny size on the CPU: exact neighbours against a
NumPy count, the comparisons on planted faults, the bfloat16 control, and
what the harness and the reference import."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from portbench import harness
from portbench.reference import judge, knn


def _data(n=2000, d=24, q=50, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, d), generator=g), torch.randn((q, d), generator=g)


def test_exact_knn_matches_numpy_brute_force():
    x, q = _data()
    ids, d = knn.exact_knn(x, q, 10)
    xd, qd = x.double().numpy(), q.double().numpy()
    full = ((qd[:, None, :] - xd[None, :, :]) ** 2).sum(-1)
    want = np.argsort(full, axis=1, kind="stable")[:, :10]
    assert np.array_equal(ids.numpy(), want)
    assert np.allclose(d.numpy(), np.take_along_axis(full, want, 1), rtol=1e-12)
    live = torch.arange(x.shape[0]) % 3 != 0
    ids_l, _ = knn.exact_knn(x, q, 10, live=live)
    assert bool(live[ids_l].all())


def test_bf16_control_misses_the_distances():
    x, q = _data()
    ids, d = knn.exact_knn(x, q, 10)
    nums, _ = judge.result_numbers(x, q, ids, d.float(), ids)
    assert nums == {"result_bad_entries": 0, "result_dist_err": nums["result_dist_err"],
                    "recall_at_10": 1.0}
    assert nums["result_dist_err"] < 1e-6
    cid, cd = knn.exact_knn_bf16(x, q, 10)
    cnums, _ = judge.result_numbers(x, q, cid, cd.float(), ids)
    assert cnums["result_dist_err"] > 1e-3


def _pool(x, r=8):
    d = torch.cdist(x.double(), x.double()).square()
    d.fill_diagonal_(torch.inf)
    dist, ids = torch.sort(d, dim=1)
    return ids[:, :r].int().contiguous(), dist[:, :r].float().contiguous()


def test_pool_numbers_count_each_broken_promise():
    x, _ = _data(n=300)
    ids, dists = _pool(x)
    good = judge.pool_numbers(x, ids, dists)
    assert good["pool_bad_entries"] == 0 and good["pool_dist_err"] < 1e-6
    for plant in (
        lambda i, d: i.__setitem__((0, 1), i[0, 0]),  # an id twice in a row
        lambda i, d: i.__setitem__((1, 0), 1),  # a self-edge
        lambda i, d: i.__setitem__((2, 0), 300),  # an id past N
        lambda i, d: d.__setitem__((3, 0), d[3, 5] + 1),  # a row out of order
        lambda i, d: i.__setitem__((4, 7), -1),  # an empty slot with a distance
    ):
        i, d = ids.clone(), dists.clone()
        plant(i, d)
        assert judge.pool_numbers(x, i, d)["pool_bad_entries"] >= 1
    d = dists.clone()
    d[5, 2] *= 1.001
    assert judge.pool_numbers(x, ids, d)["pool_dist_err"] > 5e-4


IMPORT_CHECK = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
from portbench import harness
import portbench.run, portbench.control, portbench.reference.knn, portbench.reference.judge
for sub in ("drivers", "metrics"):
    for f in sorted((harness.BENCH / sub).glob("*.py")):
        harness.load_module(f)
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_CHECK = """
import sys
sys.path[:0] = [{root!r}]
import portbench.reference.knn, portbench.reference.judge
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_names(code: str) -> set[str]:
    root = harness.ROOT
    out = subprocess.run(
        [sys.executable, "-c", code.format(src=str(root / "src"), root=str(root))],
        capture_output=True, text=True, timeout=120, check=True,
    )
    return set(out.stdout.strip().splitlines()[-1].split(","))


def test_harness_imports_neither_jax_nor_the_jax_package():
    names = _top_level_names(IMPORT_CHECK)
    assert "repro_torch" in names and "portbench" in names  # compared whole: not `repro`
    assert not names & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_reference_imports_nothing_of_the_program():
    names = _top_level_names(REFERENCE_CHECK)
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch", "benchmarks"}
