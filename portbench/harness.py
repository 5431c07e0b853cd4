"""One run of one cell: set-up, the measured window, the checks, the result.

Everything that belongs to one cell is found by name in `BENCHMARK.json`:
the cell's configuration file, its traffic file (`traffic/<traffic>.json`),
the driver kind the traffic names (`drivers/<driver>.py`), the cell's
limits (`limits/<cell>.json`) and one reader a metric
(`metrics/<metric>.py`). This module knows none of their names.

A driver module has five functions:

  * `prepare(run) -> state`: data, the program's state, the warm-up of
    every shape the window uses (all of it counts as set-up);
  * `unit(run, state)`: one unit of timed work (a build, a batch, an
    insert and its delete), recording its spans and counts; the harness
    waits for the device after it;
  * `answers(run, state)`: after the window, what the program produced
    (and any call the check needs from it); frees the program's state;
  * `control(run, state)`: the same answers from the plain reference in
    bfloat16, put in the program's place (`control.py`, the tests);
  * `judge(run, state, answers) -> dict`: the numbers compared, by name,
    each held to its limit in `limits/<cell>.json`.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import time
from pathlib import Path

import torch

from portbench import trace as T

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
WINDOW = "portbench.window"


def load_module(path: Path):
    """Import one file of the benchmark by path (metric files have dots in
    their names, so they are no importable module names)."""
    spec = importlib.util.spec_from_file_location(f"portbench_file_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def find(entries: list, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


class Cell:
    """The files of one cell, resolved by name from `BENCHMARK.json`."""

    def __init__(self, spec: dict, name: str, root: Path = ROOT):
        self.entry = find(spec["workloads"], name)
        self.name = name
        self.config_entry = find(spec["configs"], self.entry["config"])
        self.config = read_json(root / self.config_entry["file"])
        self.traffic = read_json(BENCH / "traffic" / f"{self.entry['traffic']}.json")
        self.driver_path = BENCH / "drivers" / f"{self.traffic['driver']}.py"
        self.limits = read_json(BENCH / "limits" / f"{name}.json")
        self.metrics = {
            kind: [m for m in spec[kind] if reports(m, name, spec)]
            for kind in ("end_to_end", "per_layer")
        }

    def metric_path(self, name: str) -> Path:
        return BENCH / "metrics" / f"{name}.py"


def reports(metric: dict, cell: str, spec: dict) -> bool:
    """Whether `cell` reports `metric`: its `workloads` key lists the cell,
    or it has none (an end-to-end metric of every cell; a per-layer metric
    of every cell that reports the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return reports(find(spec["end_to_end"], metric["moves"]), cell, spec)
    return True


class Run:
    """The state of one run that drivers and readers share."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 t0: float | None = None):
        self.cell = cell
        self.config, self.traffic = cell.config, cell.traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.t0 = time.perf_counter() if t0 is None else t0  # set-up counts from here
        self.setup_s = None
        self.window = None  # (start, end) on the host clock, seconds
        self.counts: dict[str, int] = {}  # work done in the window
        self.counters: dict[str, int] = {}  # the program's counters over the window
        self.rooflines: dict[str, dict] = {}  # frozen counts of the window's launches
        self.spans: list[tuple[str, float, float]] = []  # the window's spans
        self.unit_s: list[float] = []  # seconds of each unit of the window
        self.trace_record = None
        self.memory_peak = 0
        self._in_window = False
        self._span_names: set[str] = set()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def add(self, key: str, n: int, to: dict | None = None) -> None:
        to = self.counts if to is None else to
        to[key] = to.get(key, 0) + n

    @contextlib.contextmanager
    def span(self, name: str):
        """A benchmark span around a call into the program (recorded in the
        window only; in a traced run also on the profiler's timeline). The
        caller ends it with `sync()` where it times device work."""
        if not self._in_window:
            yield
            return
        self._span_names.add(name)
        mark = torch.profiler.record_function(name) if self.trace else contextlib.nullcontext()
        t0 = time.perf_counter()
        with mark:
            yield
        self.spans.append((name, t0, time.perf_counter()))

    def measure(self, unit) -> None:
        """Run `unit()` back to back, each ended by a wait for the device,
        until `seconds` have passed at a unit's end. A traced run profiles
        the whole window."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t0
        prof = None
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        self._in_window = True
        try:
            with torch.profiler.record_function(WINDOW) if self.trace else contextlib.nullcontext():
                start = end = time.perf_counter()
                while True:
                    unit()
                    self.sync()
                    self.unit_s.append(time.perf_counter() - end)
                    end += self.unit_s[-1]
                    if end - start >= self.seconds:
                        break
        finally:
            self._in_window = False
            if prof is not None:
                prof.__exit__(None, None, None)
        self.window = (start, end)
        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)
        if prof is not None:
            self.trace_record = T.from_profiler(prof, self._span_names, WINDOW)
            del prof

    def record(self, numbers: dict) -> dict:
        """What the metric readers read."""
        return {
            "setup_seconds": self.setup_s,
            "window": list(self.window),
            "counts": dict(self.counts),
            "counters": dict(self.counters),
            "rooflines": dict(self.rooflines),
            "numbers": dict(numbers),
            "spans": [list(s) for s in self.spans],
            "trace": self.trace_record,
        }


def held(numbers: dict, limits: dict) -> dict:
    """Each compared number beside its limit: {name: {value, limit, better,
    ok}}. A number without a limit, or a limit without its number, is an
    error of the benchmark."""
    if set(numbers) != set(limits):
        raise KeyError(f"numbers {sorted(numbers)} and limits {sorted(limits)} differ")
    out = {}
    for name, value in numbers.items():
        lim, better = limits[name]["limit"], limits[name]["better"]
        ok = value <= lim if better == "lower" else value >= lim
        out[name] = {"value": value, "limit": lim, "better": better, "ok": bool(ok)}
    return out


def device_info(run: Run) -> dict:
    if run.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(run.device),
        "count": 1,
        "memory_peak_bytes": int(run.memory_peak),
    }


def execute(run: Run) -> dict:
    """Run the cell once; returns the result object (the line run.py
    prints)."""
    driver = load_module(run.cell.driver_path)
    if run.device.type == "cuda":
        from repro_torch.kernels import _build  # the program's kernel build, cached in the checkout

        _build.build_all()
    state = driver.prepare(run)
    run.measure(lambda: driver.unit(run, state))
    answers = driver.answers(run, state)
    checks = held(driver.judge(run, state, answers), run.cell.limits)
    del answers, state
    return result(run, checks)


def result(run: Run, checks: dict) -> dict:
    cell = run.cell
    record = run.record({k: v["value"] for k, v in checks.items()})
    kind = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in cell.metrics[kind]:
        value = load_module(cell.metric_path(m["name"])).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = all(c["ok"] for c in checks.values())
    attempted = int(run.counts.get(run.traffic["unit"], 0))
    out = {
        "correct": correct,
        "attempted": attempted,
        "failed": 0 if correct else attempted,
        "metrics": metrics,
        "device": device_info(run),
    }
    if run.trace:
        tr = run.trace_record
        lo, hi = tr["window"]
        out["device"]["busy_s"] = T.busy_us(tr) / 1e6
        out["device"]["window_s"] = (hi - lo) / 1e6
        out["breakdown"] = {"device_ops": T.top_ops(tr), "idle_gaps": T.idle_gaps(tr)}
    out["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in checks.items()}
    return out


def window_line(run: Run) -> str:
    """How the window went: its units and the spread of their seconds."""
    u = sorted(run.unit_s)
    return (f"window: {len(u)} units in {run.window[1] - run.window[0]:.3f} s; a unit "
            f"{u[0]:.4f} / {u[len(u) // 2]:.4f} / {u[-1]:.4f} s (min / median / max)")


def check_lines(out: dict) -> list[str]:
    """The compared numbers beside their limits, one a line."""
    return [
        f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in out["checks"].items()
    ] + [f"correct: {out['correct']}"]
