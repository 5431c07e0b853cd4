"""`BENCHMARK.json` against the benchmark's contract, and every cell resolved
by name to its files."""

from __future__ import annotations

import re

import pytest

from portbench import harness, tiny

SPEC = tiny.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
HELD = tiny.spec(held_out=True)
HELD_CELLS = [w["name"] for w in HELD["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        assert len({e["name"] for e in group}) == len(group)
    for e in SPEC["configs"] + SPEC["workloads"] + METRICS:
        assert NAME.match(e["name"]), e["name"]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [e["why"] for e in SPEC["configs"] + SPEC["workloads"]] + [
        c["source"] for c in SPEC["configs"]
    ] + [m["layer"] for m in SPEC["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (harness.ROOT / c["file"]).is_file()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_config_used_and_pairs_unique():
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", HELD_CELLS)
def test_cell_resolves_to_its_files(cell):
    """Every cell, and every cell held out of `BENCHMARK.json`
    (`held_out.json`), by name."""
    c = harness.Cell(HELD, cell)
    driver = harness.load_module(c.driver_path)
    for fn in ("prepare", "unit", "answers", "control", "judge"):
        assert callable(getattr(driver, fn))
    assert c.traffic["unit"] and c.limits
    for kind in ("end_to_end", "per_layer"):
        for m in c.metrics[kind]:
            assert callable(harness.load_module(c.metric_path(m["name"])).read)
    e2e = {m["name"] for m in c.metrics["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.metrics["per_layer"]
    for m in c.metrics["per_layer"]:
        assert m["moves"] in e2e  # a per-layer metric's cell reports what it moves


def test_harness_names_no_cell_or_metric():
    """Cells and metrics are found by name: the generic code names none of
    them."""
    names = CELLS + [m["name"] for m in METRICS]
    for f in ("run.py", "harness.py"):
        text = (harness.BENCH / f).read_text()
        for name in names:
            assert not re.search(rf"[\"']{re.escape(name)}[\"']", text), (f, name)
