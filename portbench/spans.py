"""The program's own spans in a cell's traced run: device time and idle gaps
by the span of `repro_torch` that launched the work, and the program's
counters over the window.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds 10

On the card. One traced run of the cell, as `run.py --trace 1` makes it,
whose result line is printed first; then one JSON line of the breakdown by
program span (`breakdown`). The benchmark's own runs never run this: their
trace (`trace.from_profiler`) keeps the benchmark's spans only.

The program's spans (`repro_torch.trace.SPANS`) are host events on the
profiler's clock. Each device operation is put down to the innermost
program span open on the host when it was launched: its correlation id
names its launch call (a CUDA runtime or driver call, `cu...`) among the
host's events.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def raw_events(prof) -> list[tuple]:
    """(name, on the device, start ns, duration ns, correlation id) of each
    event of a `torch.profiler.profile`. The correlation id is kept for the
    device's operations and the host's CUDA calls, and is 0 for every other
    host event, whose ids number operators, another series."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        dev = e.device_type() != torch.autograd.DeviceType.CPU
        corr = e.correlation_id() if dev or name.startswith("cu") else 0
        out.append((name, dev, e.start_ns(), e.duration_ns(), corr))
    return out


def nesting(spans):
    """(parents, innermost) of properly nested host spans [(name, start,
    end, ...)]: each span's enclosing span's index (None at the top), and a
    function of a time that gives the name of the innermost span open then
    (None outside every span)."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1], -spans[i][2]))
    parent = [None] * len(spans)
    times, owners, stack = [], [], []

    def close_until(t):
        while stack and spans[stack[-1]][2] <= t:
            j = stack.pop()
            times.append(spans[j][2])
            owners.append(stack[-1] if stack else None)

    for i in order:
        close_until(spans[i][1])
        parent[i] = stack[-1] if stack else None
        stack.append(i)
        times.append(spans[i][1])
        owners.append(i)
    close_until(float("inf"))

    def innermost(t):
        k = bisect.bisect_right(times, t) - 1
        return None if k < 0 or owners[k] is None else spans[owners[k]][0]

    return parent, innermost


def from_events(raw, span_names, window_name: str, program_spans) -> dict:
    """The trace record `trace.from_profiler` makes, from `raw_events`, with
    two more keys:

      * `program_spans`: [[name, start, end, parent], ...], the host events
        named in `program_spans`, each with its innermost enclosing program
        span's name (None at the top);
      * `kernel_spans`: beside each entry of `kernels`, the name of the
        innermost program span open on the host at its launch, None where
        none was open or no launch call was recorded.

    Device-side events named as program spans are left out of `kernels`, as
    the benchmark's own spans are."""
    base = min((t for _, _, t, _, _ in raw), default=0)
    kernels, kcorr, spans, prog, launch_at, window = [], [], [], [], {}, None
    for name, dev, start, dur, corr in raw:
        a = (start - base) / 1e3
        b = a + dur / 1e3
        if dev:
            if name != window_name and name not in span_names and name not in program_spans:
                kernels.append((name, a, b))
                kcorr.append(corr)
        elif name == window_name:
            window = [a, b]
        elif name in span_names:
            spans.append((name, a, b))
        elif name in program_spans:
            prog.append((name, a, b))
        elif corr:
            launch_at[corr] = a
    if window is None:
        raise RuntimeError(f"the profiler recorded no {window_name!r} span")
    parent, owner = nesting(prog)
    return {
        "window": window,
        "kernels": kernels,
        "spans": spans,
        "program_spans": [[n, a, b, None if p is None else prog[p][0]]
                          for (n, a, b), p in zip(prog, parent)],
        "kernel_spans": [owner(launch_at[c]) if c in launch_at else None for c in kcorr],
    }


def span_device_us(trace: dict, name: str | None) -> tuple[float, int]:
    """(device microseconds of the window's kernels whose innermost program
    span is `name` (None: no span), the `name` spans that start in the
    window)."""
    lo, hi = trace["window"]
    us = 0.0
    for (_, a, b), owner in zip(trace["kernels"], trace["kernel_spans"]):
        if owner == name and min(b, hi) > max(a, lo):
            us += min(b, hi) - max(a, lo)
    n = sum(1 for s in trace["program_spans"] if s[0] == name and lo <= s[1] <= hi)
    return us, n


def gaps(trace: dict) -> list[tuple[float, float]]:
    """Every stretch of the window with no device operation: (start, end)."""
    from portbench import trace as T

    lo, hi = trace["window"]
    out, t = [], lo
    for a, b in T.union(T.clipped(trace["kernels"], lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def idle_in(trace: dict, name: str) -> tuple[float, int]:
    """(idle microseconds of the window's gaps whose midpoint lies inside a
    `name` program span, the `name` spans that start in the window)."""
    lo, hi = trace["window"]
    inside = sorted((a, b) for n, a, b, _ in trace["program_spans"] if n == name)
    starts = [a for a, _ in inside]
    us = 0.0
    for a, b in gaps(trace):
        mid = (a + b) / 2
        k = bisect.bisect_right(starts, mid) - 1
        if k >= 0 and mid <= inside[k][1]:
            us += b - a
    return us, sum(1 for a, _ in inside if lo <= a <= hi)


def named_gaps(trace: dict, n: int = 10) -> list[list]:
    """The n longest idle gaps, each named by the innermost span of either
    kind, the benchmark's or the program's, open at its middle: [span, s]."""
    from portbench import trace as T

    both = trace["spans"] + [s[:3] for s in trace["program_spans"]]
    return T.idle_gaps({**trace, "spans": both}, n)


def slow_calls(raw, trace: dict, n: int = 10) -> list[list]:
    """The n longest CUDA calls of the host in the window (`cu...`: launches,
    copies, allocations) but its waits for the card (`...Synchronize`),
    each with the innermost span of either kind open at its start: [name,
    ms, span]. A call the host stalls in while the card drains its queue
    shows as an idle gap."""
    base = min((t for _, _, t, _, _ in raw), default=0)
    lo, hi = trace["window"]
    _, innermost = nesting(trace["spans"] + trace["program_spans"])
    calls = []
    for name, dev, start, dur, _ in raw:
        a = (start - base) / 1e3
        if not dev and name.startswith("cu") and "Synchronize" not in name and lo <= a <= hi:
            calls.append([name, dur / 1e6, innermost(a) or "outside the spans"])
    return sorted(calls, key=lambda c: c[1], reverse=True)[:n]


def readings(trace: dict, counters: dict, units: dict) -> dict:
    """The per-layer readings the program's spans and counters allow, each
    a unit of the cell (a build, a search call) where the cell has it."""
    out = {}
    builds, batches = units.get("builds"), units.get("batches")
    if builds:
        out["build.stage_device_ms"] = span_device_us(trace, "pools.stage")[0] / 1e3 / builds
    if batches:
        out["search.beam_device_ms"] = span_device_us(trace, "search.beam")[0] / 1e3 / batches
        us, steps = idle_in(trace, "search.step")
        if steps:
            out["search.step_idle_us"] = us / steps
        out["search.host_syncs"] = counters.get("host_sync/search.frontier", 0) / batches
    return out


def breakdown(trace: dict, counters: dict, units: dict, program_spans) -> dict:
    """Device ms a unit by innermost program span (and the spans a unit),
    the unattributed remainder, the idle ms a unit by the innermost span
    of either kind at each gap's middle, the longest gaps, and the
    program's counters a unit."""
    from portbench import trace as T

    unit = units.get("builds") or units.get("batches") or 1
    lo, hi = trace["window"]
    by = {}
    for name in [*program_spans, None]:
        us, n = span_device_us(trace, name)
        by[name or "unattributed"] = [us / 1e3 / unit, n / unit]
    total_us = sum(b - a for _, a, b in T.clipped(trace["kernels"], lo, hi))
    _, innermost = nesting(trace["spans"] + trace["program_spans"])
    idle = {}
    for a, b in gaps(trace):
        name = innermost((a + b) / 2) or "outside the spans"
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e3 / unit
    return {
        "unit": "build" if units.get("builds") else "search call",
        "units": unit,
        "device_ms": total_us / 1e3 / unit,
        "device_ms_by_span": by,
        # the spans' shares and the remainder, summed: 1 unless a kernel is lost
        "attributed_share": sum(v[0] for v in by.values()) * 1e3 * unit / total_us
        if total_us else None,
        "idle_ms_by_span": idle,
        "idle_gaps": named_gaps(trace),
        "counters": {k: v / unit for k, v in counters.items() if v},
        "readings": readings(trace, counters, units),
    }


def traced(cell, seed: int, seconds: float, device):
    """One traced run of `cell`: (the result line, the trace record with
    the program's spans, the program's counters over the window, the
    window's units, the profiler's raw events)."""
    from portbench import harness
    from portbench import trace as T
    from repro_torch import trace as P

    class SpanRun(harness.Run):
        def measure(self, unit):
            # the harness drops the profiler once `from_profiler` has read
            # it: keep its raw events on the way
            keep = T.from_profiler

            def capture(prof, span_names, window_name):
                self.raw, self.span_names = raw_events(prof), set(span_names)
                return keep(prof, span_names, window_name)

            before = P.counts()
            T.from_profiler = capture
            try:
                super().measure(unit)
            finally:
                T.from_profiler = keep
            after = P.counts()
            self.program_counters = {k: v - before.get(k, 0) for k, v in after.items()}

    run = SpanRun(cell, seed, seconds, True, device)
    out = harness.execute(run)
    tr = from_events(run.raw, run.span_names, harness.WINDOW, set(P.SPANS))
    return out, tr, run.program_counters, dict(run.counts), run.raw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch

    from portbench import harness
    from repro_torch import trace as P

    if not torch.cuda.is_available():
        print("portbench spans: no CUDA device", file=sys.stderr)
        return 2
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(spec, args.workload)
    out, tr, counters, units, raw = traced(cell, args.seed, args.seconds, "cuda")
    print(json.dumps(out), flush=True)
    print(json.dumps({"cell": args.workload, "seed": args.seed,
                      "breakdown": breakdown(tr, counters, units, P.SPANS),
                      "slow_calls": slow_calls(raw, tr)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
