"""The program's spans in a traced window (`portbench/spans.py`): kernels put
down to the innermost program span open at their launch, the readings by
hand, the accepted readers unmoved by the program's spans, and a tiny
traced run of each static cell on the CPU."""

from __future__ import annotations

import pytest

from portbench import harness, spans, tiny
from portbench import trace as T
from repro_torch import trace as P

US = 1000  # ns


def ev(name, dev, a_us, dur_us, corr=0):
    return (name, dev, a_us * US, dur_us * US, corr)


# a build: a round with a stage inside; ops carry no correlation (their ids
# number operators), launch calls carry the id their kernel carries
PROGRAM = [
    ev("grnnd.round", False, 100, 2000),
    ev("pools.stage", False, 500, 1000),
    ev("pools.stage", True, 700, 300),  # a device-side mirror of the span
]
RAW = [
    ev("portbench.window", False, 0, 10000),
    ev("build", False, 0, 5000),
    ev("build", True, 250, 3000),  # the benchmark span's device-side mirror
    ev("aten::sort", False, 600, 100),
    ev("cudaLaunchKernel", False, 650, 10, 7),
    ev("cudaLaunchKernel", False, 200, 10, 8),
    ev("cudaLaunchKernel", False, 3000, 10, 9),
    ev("sort_kernel", True, 700, 300, 7),
    ev("rng_round_kernel<float>", True, 250, 200, 8),
    ev("gather", True, 3100, 100, 9),
    ev("memset", True, 4000, 50, 99),  # no launch call recorded
    ev("cudaStreamSynchronize", False, 1200, 900),  # a wait for the card
]


def traced(program=True):
    raw = RAW + (PROGRAM if program else [])
    return spans.from_events(raw, {"build"}, harness.WINDOW, set(P.SPANS))


def metric(name: str, record: dict):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read(record)


def test_kernels_go_to_the_innermost_span_open_at_their_launch():
    tr = traced()
    assert [k[0] for k in tr["kernels"]] == ["sort_kernel", "rng_round_kernel<float>",
                                             "gather", "memset"]
    assert tr["kernel_spans"] == ["pools.stage", "grnnd.round", None, None]
    assert tr["program_spans"] == [["grnnd.round", 100.0, 2100.0, None],
                                   ["pools.stage", 500.0, 1500.0, "grnnd.round"]]
    assert tr["spans"] == [("build", 0.0, 5000.0)] and tr["window"] == [0.0, 10000.0]
    assert spans.span_device_us(tr, "pools.stage") == (300.0, 1)
    assert spans.span_device_us(tr, "grnnd.round") == (200.0, 1)
    assert spans.span_device_us(tr, None) == (150.0, 0)
    # the host's CUDA calls but its waits, longest first, by innermost span
    assert spans.slow_calls(RAW + PROGRAM, tr, 2) == [["cudaLaunchKernel", 0.01, "pools.stage"],
                                                      ["cudaLaunchKernel", 0.01, "grnnd.round"]]


def test_accepted_readers_read_the_same_with_the_program_spans():
    rooflines = {"rng_round": {"bound_s": 50e-6, "launches": 1}}
    readers = ["build.pool_device_ms", "rng_round_roofline", "search_expand_roofline",
               "device.idle_pct.build", "device.idle_pct.search"]
    with_spans, without = ({"trace": traced(p), "counts": {"builds": 1}, "rooflines": rooflines}
                           for p in (True, False))
    got = {m: metric(m, with_spans) for m in readers}
    assert got == {m: metric(m, without) for m in readers}
    assert got["build.pool_device_ms"] == pytest.approx(0.45)  # sort, gather, memset
    assert got["rng_round_roofline"] == pytest.approx(25.0)
    assert T.top_ops(with_spans["trace"]) == T.top_ops(without["trace"])
    assert T.idle_gaps(with_spans["trace"]) == T.idle_gaps(without["trace"])


SEARCH = {
    "window": [0.0, 1000.0],
    "kernels": [["frontier_any", 0.0, 100.0], ["topr_merge", 300.0, 400.0],
                ["copy", 900.0, 1000.0]],
    "kernel_spans": ["search.frontier", "search.beam", None],
    "spans": [["search", 0.0, 1000.0]],
    "program_spans": [["search.step", 0.0, 500.0, None],
                      ["search.frontier", 0.0, 150.0, "search.step"],
                      ["search.beam", 250.0, 450.0, "search.step"],
                      ["search.step", 500.0, 600.0, None],
                      ["search.frontier", 500.0, 550.0, "search.step"]],
}


def test_readings_by_hand():
    # idle 100-300 (middle 200: in the first step, past its frontier test)
    # and 400-900 (middle 650: in the call, past both steps)
    assert spans.gaps(SEARCH) == [(100.0, 300.0), (400.0, 900.0)]
    assert spans.idle_in(SEARCH, "search.step") == (200.0, 2)
    assert spans.named_gaps(SEARCH) == [["search", 500e-6], ["search.step", 200e-6]]
    counters = {"host_sync/search.frontier": 2, "host_sync/search.expanded": 1}
    got = spans.breakdown(SEARCH, counters, {"batches": 1}, P.SPANS)
    assert got["readings"] == {"search.beam_device_ms": pytest.approx(0.1),
                               "search.step_idle_us": 100.0, "search.host_syncs": 2.0}
    assert got["device_ms_by_span"]["search.frontier"] == [pytest.approx(0.1), 2.0]
    assert got["device_ms_by_span"]["unattributed"] == [pytest.approx(0.1), 0.0]
    assert got["device_ms"] == pytest.approx(0.3) and got["attributed_share"] == pytest.approx(1.0)
    assert got["idle_ms_by_span"] == {"search.step": pytest.approx(0.2),
                                      "search": pytest.approx(0.5)}
    assert got["counters"] == {"host_sync/search.frontier": 2.0, "host_sync/search.expanded": 1.0}
    build = spans.readings(traced(), {}, {"builds": 2})
    assert build == {"build.stage_device_ms": pytest.approx(0.15)}


@pytest.mark.parametrize("cell", ["sift1m.build", "sift1m.search"])
def test_tiny_traced_run_carries_the_program_spans(cell):
    c = tiny.cell(cell)
    out, tr, counters, units, _ = spans.traced(c, 2**31 + 11, 0.3, "cpu")
    assert out["correct"], out["checks"]
    names = [s[0] for s in tr["program_spans"]]
    if "builds" in units:
        b = c.config["build"]
        assert names.count("grnnd.round") == units["builds"] * b["t1"] * b["t2"]
        assert names.count("pools.stage") == units["builds"] * (b["t1"] * b["t2"] + b["t1"] - 1)
        assert counters["host_sync/grnnd.reverse"] == units["builds"] * (b["t1"] - 1)
    else:
        frontier = counters["host_sync/search.frontier"]
        assert names.count("search.step") == frontier > units["batches"]
        assert counters["host_sync/search.entry"] == units["batches"]
    assert tr["kernels"] == [] and tr["kernel_spans"] == []  # no device on the CPU
