"""The frozen roofline counts of the benchmark's kernels, and the peaks.

A copy of the byte and operation counts of the kernel rows that
`chip_smoke.py` times (its `phase_kernels`), frozen here so that a later
change to the program cannot change the yardstick. A kernel's least time is
the larger of its bytes over the card's bandwidth and its fp32 operations
over the card's fp32 rate. Each input byte is counted once and each output
byte once, whatever the kernel reads again; where the work depends on the
data, the counts take what the given inputs need.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, without sparsity.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_FP32_PER_S = 67e12  # fp32 outside the tensor cores


def bound_s(nbytes: float, ops_fp32: float) -> float:
    """Least seconds of a kernel that moves `nbytes` and does `ops_fp32`."""
    return max(nbytes / PEAK_BYTES_PER_S, ops_fp32 / PEAK_FP32_PER_S)


def rng_round(c: int, r: int, p: int, d: int, unique_rows: int) -> tuple[float, float]:
    """(bytes, fp32 ops) of one fp32 `rng_round` launch (B1) over C pool rows
    of R slots with P sampled pairs each: the distinct stored rows the pools
    name (D fp32 each), the pool's ids, dists and kill mask (9 B a slot), the
    pairs' two slot indices in and dst / src / dist out (20 B a pair); three
    operations (difference, product, sum) a pair and dimension."""
    return unique_rows * d * 4 + c * r * 9 + c * p * 20, 3 * c * p * d


def search_expand(
    q: int, r: int, h: int, d: int, unique_rows: int, live: int
) -> tuple[float, float]:
    """(bytes, fp32 ops) of one fp32 `search_expand` launch (B3) without the
    tombstone mask or the filter: the distinct neighbor rows of the step, the
    queries, the neighbor ids in and ids / dists / fresh out (13 B a slot),
    and the visited-table slots probed (an 8-slot window a live neighbor, at
    most the whole (Q, H) table); three operations a live neighbor and
    dimension."""
    return (
        unique_rows * d * 4 + q * d * 4 + q * r * 13 + min(q * h, live * 8) * 4,
        3 * live * d,
    )
