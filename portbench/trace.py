"""Reductions of a traced window: busy time, idle gaps, device time by kernel.

A traced run's record holds `trace = {"window": [start, end], "kernels":
[[name, start, end], ...], "spans": [[name, start, end], ...]}`, all in the
profiler's microseconds: the device operations and the benchmark's own
spans. These functions read it; the per-layer metric readers call them.
"""

from __future__ import annotations

import torch


def clipped(intervals, lo: float, hi: float):
    """The intervals cut to [lo, hi], empty ones dropped."""
    out = []
    for name, a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((name, a, b))
    return out


def union(intervals) -> list[tuple[float, float]]:
    """The union of (name, start, end) intervals as disjoint (start, end)."""
    merged: list[list[float]] = []
    for _, a, b in sorted(intervals, key=lambda t: t[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_us(trace: dict) -> float:
    lo, hi = trace["window"]
    return sum(b - a for a, b in union(clipped(trace["kernels"], lo, hi)))


def idle_pct(trace: dict | None) -> float | None:
    """Share of the window in which no device operation ran, in %."""
    if not trace or not trace["kernels"]:
        return None
    lo, hi = trace["window"]
    return 100.0 * (1.0 - busy_us(trace) / (hi - lo))


def device_us(trace: dict | None, match) -> tuple[float, int]:
    """(device microseconds, launches) of the kernels in the window whose name
    `match(name)` accepts."""
    if not trace:
        return 0.0, 0
    lo, hi = trace["window"]
    hits = [(a, b) for name, a, b in clipped(trace["kernels"], lo, hi) if match(name)]
    return sum(b - a for a, b in hits), len(hits)


def top_ops(trace: dict, n: int = 10) -> list[list]:
    """The n kernels by name that took the most device time: [name, s]."""
    lo, hi = trace["window"]
    by: dict[str, float] = {}
    for name, a, b in clipped(trace["kernels"], lo, hi):
        by[name] = by.get(name, 0.0) + (b - a)
    top = sorted(by.items(), key=lambda kv: kv[1], reverse=True)[:n]
    return [[name[:160], us / 1e6] for name, us in top]


def idle_gaps(trace: dict, n: int = 10) -> list[list]:
    """The n longest stretches of the window with no device operation, each
    named by the innermost benchmark span the host was in at its middle:
    [span, s]."""
    lo, hi = trace["window"]
    busy = union(clipped(trace["kernels"], lo, hi))
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    out = []
    for a, b in sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:n]:
        mid = (a + b) / 2
        inside = [(e - s, name) for name, s, e in trace["spans"] if s <= mid <= e]
        out.append([min(inside)[1] if inside else "outside the spans", (b - a) / 1e6])
    return out


def from_profiler(prof, span_names, window_name: str) -> dict:
    """The trace record of a `torch.profiler.profile` over one window: the
    device operations (the card's side of the timeline, without the
    annotations the spans leave there) and the host's benchmark spans. Read
    from the profiler's raw events: building its `events()` tree takes
    minutes for a window of host-bound steps."""
    raw = [(e.name(), e.device_type(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()]
    base = min((t for _, _, t, _ in raw), default=0)
    kernels, spans, window = [], [], None
    for name, dev, start, dur in raw:
        a = (start - base) / 1e3
        b = a + dur / 1e3
        named = name == window_name or name in span_names
        if dev != torch.autograd.DeviceType.CPU:
            if not named:
                kernels.append((name, a, b))
        elif name == window_name:
            window = [a, b]
        elif named:
            spans.append((name, a, b))
    if window is None:
        raise RuntimeError(f"the profiler recorded no {window_name!r} span")
    return {"window": window, "kernels": kernels, "spans": spans}


def span_mean_ms(spans, name: str) -> float | None:
    """Mean milliseconds of the host spans called `name`."""
    d = [b - a for n, a, b in spans if n == name]
    return 1e3 * sum(d) / len(d) if d else None


def roofline_pct(record: dict, kernel: str) -> float | None:
    """The frozen count's least time of the window's `kernel` launches over
    their device time, in %; None where the trace has none of them or holds
    another number of them than were counted."""
    counted = record["rooflines"].get(kernel)
    us, n = device_us(record["trace"], lambda name: f"{kernel}_kernel" in name)
    if counted is None or n == 0 or n != counted["launches"]:
        return None
    return 100.0 * counted["bound_s"] / (us / 1e6)
