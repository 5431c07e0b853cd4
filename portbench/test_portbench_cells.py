"""The cells of `BENCHMARK.json` that `test_portbench_drivers.py` does not
list, end to end at a tiny size on the CPU as that file runs its own: a
sound run is correct and reports its cell's metrics, and the bfloat16
control is refused; so is `gist1m.search`, held out of `BENCHMARK.json`
with its traffic and limits files kept. Also `reference/knn_big.py`
against `knn.exact_knn`."""

from __future__ import annotations

import pytest
import torch

from portbench import control, harness, test_portbench_drivers as drivers, tiny
from portbench.reference import knn, knn_big
from repro_torch.core import pools

CELLS = [w["name"] for w in tiny.spec()["workloads"] if w["name"] not in drivers.CELLS]

# `gist1m.search`: held out until its `search_qps` runs spread less (the
# search loop's two host waits a step); its entry, and the metrics whose
# `workloads` would list it
GIST_SEARCH = {
    "name": "gist1m.search", "config": "gist1m", "traffic": "search_10k", "chips": 1,
    "why": "one client's batches of 10,000 queries at ef 64, hashed visited set (evaluation "
           "sweeps, k-NN joins over 960-wide descriptors): the search loop and B3 at 960-wide rows",
}
GIST_SEARCH_METRICS = ("search_qps", "recall_at_10", "search.steps", "search_expand_roofline",
                       "device.idle_pct.search")


def _gist_search() -> harness.Cell:
    s = tiny.spec(held_out=True)
    s["workloads"] = s["workloads"] + [GIST_SEARCH]
    for m in s["end_to_end"] + s["per_layer"]:
        if m["name"] in GIST_SEARCH_METRICS:
            m["workloads"] = m["workloads"] + [GIST_SEARCH["name"]]
    c = harness.Cell(s, GIST_SEARCH["name"])
    c.config = {**c.config, **tiny.CONFIG}
    c.traffic = {**c.traffic, **tiny.TRAFFIC["search"]}
    return c


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(cell, trace, monkeypatch):
    big = tiny.cell(cell).traffic["driver"] == "build_big"
    if big:  # the tiny builds' 48,000 requests a staging, in slices
        monkeypatch.setattr(pools, "STAGE_BUDGET", 10_000)
    out = drivers.run(cell, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    if not trace:
        names = {m["name"] for m in tiny.cell(cell).metrics["end_to_end"]}
        assert set(out["metrics"]) == names  # every end-to-end metric, from a CPU run too
    else:
        assert out["device"]["window_s"] > 0 and "breakdown" in out
        if big:  # the program's tally, a build
            assert out["metrics"]["build.stage_slices"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused(cell):
    c = tiny.cell(cell)
    got = control.readings(c, drivers.SEED, 0.3, "cpu")
    assert all(harness.held(got["program"], c.limits)[k]["ok"] for k in c.limits)
    assert not all(v["ok"] for v in harness.held(got["control"], c.limits).values())


@pytest.mark.parametrize("trace", [False, True])
def test_held_out_gist_search_is_correct(trace):
    c = _gist_search()
    out = harness.execute(harness.Run(c, drivers.SEED, 0.3, trace, "cpu"))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in c.metrics["end_to_end"]}
    assert names == {"search_qps", "recall_at_10", "setup_s"}
    assert {m["name"] for m in c.metrics["per_layer"]} == set(GIST_SEARCH_METRICS) - names
    if not trace:
        assert set(out["metrics"]) == names
    else:
        assert out["device"]["window_s"] > 0 and "breakdown" in out


def test_held_out_gist_search_control_is_refused():
    c = _gist_search()
    got = control.readings(c, drivers.SEED, 0.3, "cpu")
    assert all(harness.held(got["program"], c.limits)[k]["ok"] for k in c.limits)
    assert not all(v["ok"] for v in harness.held(got["control"], c.limits).values())


@pytest.mark.parametrize("block", [1, 7, 64, None])
def test_knn_big_is_knn_at_any_block(block):
    g = torch.Generator().manual_seed(9)
    x, q = torch.randn((3000, 24), generator=g), torch.randn((150, 24), generator=g)
    x[1] = x[0]  # a tie in distance
    for big, small in ((knn_big.exact_knn, knn.exact_knn),
                       (knn_big.exact_knn_bf16, knn.exact_knn_bf16)):
        ids, d = big(x, q, 10, block=block)
        want_ids, want_d = small(x, q, 10)
        assert ids.dtype == want_ids.dtype and d.dtype == want_d.dtype == torch.float64
        assert torch.equal(ids, want_ids) and torch.equal(d, want_d)


def test_query_block_keeps_the_candidates_under_the_budget():
    assert knn_big.query_block(10**6) == knn.QUERY_BLOCK
    assert knn_big.query_block(10**7) == (1 << 30) // 10**7 == 107
    assert knn_big.query_block(10**12) == 1
    assert knn_big.query_block(10**7) * 10**7 <= knn_big.CAND_ELEMS
