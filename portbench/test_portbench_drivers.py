"""Each driver end to end at a tiny size on the CPU: a sound run is correct
and reports its cell's metrics, and the bfloat16 control is refused. The
look for a card is skipped: `harness.execute` runs on `device="cpu"`."""

from __future__ import annotations

import pytest

from portbench import control, harness, tiny

CELLS = ["sift1m.build", "sift1m.search", "sift1m.churn"]
SEED = 2**31 + 11


def run(cell: str, trace: bool = False) -> dict:
    return harness.execute(harness.Run(tiny.cell(cell), SEED, 0.3, trace, "cpu"))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(cell, trace):
    out = run(cell, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    if not trace:
        names = {m["name"] for m in tiny.cell(cell).metrics["end_to_end"]}
        assert set(out["metrics"]) == names  # every end-to-end metric, from a CPU run too
    else:
        assert out["device"]["window_s"] > 0 and "breakdown" in out


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused(cell):
    c = tiny.cell(cell)
    got = control.readings(c, SEED, 0.3, "cpu")
    assert all(harness.held(got["program"], c.limits)[k]["ok"] for k in c.limits)
    assert not all(v["ok"] for v in harness.held(got["control"], c.limits).values())
