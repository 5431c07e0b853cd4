"""The arithmetic of the readers on synthetic records, and the frozen
roofline counts against PERF.md's bound column."""

from __future__ import annotations

import pytest

from portbench import harness, trace
from portbench.rooflines import counts

TRACE = {
    "window": [0.0, 1000.0],
    # two overlapping kernels, one apart, one outside the window
    "kernels": [
        ["rng_round_kernel<float>", 100.0, 300.0],
        ["sort", 200.0, 400.0],
        ["gather", 600.0, 700.0],
        ["late", 1200.0, 1300.0],
    ],
    "spans": [["build", 0.0, 500.0], ["build", 500.0, 1000.0], ["search", 750.0, 1000.0]],
}


def metric(name: str, record: dict):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read(record)


def test_union_and_idle_share():
    assert trace.union([["a", 0, 2], ["b", 1, 3], ["c", 5, 6]]) == [(0, 3), (5, 6)]
    assert trace.busy_us(TRACE) == 400.0
    assert trace.idle_pct(TRACE) == pytest.approx(60.0)
    assert trace.idle_pct({"window": [0, 1], "kernels": [], "spans": []}) is None
    for cell in ("build", "search", "churn"):
        assert metric(f"device.idle_pct.{cell}", {"trace": TRACE}) == pytest.approx(60.0)


def test_idle_gaps_named_by_innermost_span():
    gaps = trace.idle_gaps(TRACE)
    assert gaps[0] == ["search", 300.0 / 1e6]  # 700-1000: inside build and search
    assert gaps[1] == ["build", 200.0 / 1e6]  # 400-600
    assert gaps[2] == ["build", 100.0 / 1e6]  # 0-100
    assert trace.top_ops(TRACE)[0] == ["rng_round_kernel<float>", 200.0 / 1e6]


def test_per_build_and_rates():
    rec = {"window": [10.0, 14.0], "counts": {"builds": 4, "queries": 200_000,
                                              "vectors_inserted": 100_000, "batches": 2},
           "counters": {"search_expand": 330}, "trace": TRACE, "setup_seconds": 12.5,
           "spans": [["insert", 0.0, 0.25], ["insert", 1.0, 1.75], ["delete", 2.0, 2.01]],
           "numbers": {"recall_at_10": 0.64}, "rooflines": {}}
    assert metric("build_s", rec) == 1.0
    assert metric("search_qps", rec) == 50_000.0
    assert metric("insert_rate", rec) == 25_000.0
    assert metric("setup_s", rec) == 12.5
    assert metric("recall_at_10", rec) == 0.64
    assert metric("search.steps", rec) == 165.0
    assert metric("churn.insert_ms", rec) == pytest.approx(500.0)
    assert metric("churn.delete_ms", rec) == pytest.approx(10.0)
    # every device op but B1's, per build: the sort's 200 us and the gather's
    # 100 us (each kernel's own time, overlaps included), over 4 builds
    assert metric("build.pool_device_ms", rec) == pytest.approx((200.0 + 100.0) / 1e3 / 4)
    assert metric("build_s", {**rec, "counts": {}}) is None


def test_roofline_share_needs_matching_launches():
    rec = {"trace": TRACE, "rooflines": {"rng_round": {"bound_s": 50e-6, "launches": 1}}}
    assert metric("rng_round_roofline", rec) == pytest.approx(25.0)
    rec["rooflines"]["rng_round"]["launches"] = 2
    assert metric("rng_round_roofline", rec) is None
    assert metric("search_expand_roofline", rec) is None


def test_frozen_counts_give_perf_md_bounds():
    # B1 at C = 10^6, R = P = 48, d 128: every row named (PERF.md §6: 0.568 ms)
    b = counts.rng_round(10**6, 48, 48, 128, 10**6)
    assert round(counts.bound_s(*b) * 1e3, 3) == 0.568
    assert b[0] / counts.PEAK_BYTES_PER_S > b[1] / counts.PEAK_FP32_PER_S  # bound by bytes
    # B3 at Q = 10^4, R = 48, H = 512, d 128 (PERF.md §6: 0.040 ms). The row's
    # inputs were 10^4 random pools of a build after one round; the row kept
    # only the bound. Their live count and distinct rows are taken here as a
    # mean live degree of 25.3 and the distinct count of that many uniform
    # draws over 10^6 rows, which give the printed bound
    live = 253_000
    unique = round(10**6 * (1 - (1 - 1e-6) ** live))
    b3 = counts.search_expand(10**4, 48, 512, 128, unique, live)
    assert round(counts.bound_s(*b3) * 1e3, 3) == 0.040
    # the most the inputs could need: every slot live and distinct
    assert counts.bound_s(*counts.search_expand(10**4, 48, 512, 128, 480_000, 480_000)) > 8e-5
