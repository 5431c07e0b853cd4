#!/usr/bin/env python3
"""Time the kernel rows of `chip_smoke.py` (its phases 1 and 2) in one
checkout, for comparisons of two kernel versions on one card.

    python3 tools/kernel_rows.py --tree path/to/checkout [--match search_expand]

Imports `chip_smoke` and `repro_torch` from `<tree>` (kernels build into that
tree's `build/`), draws the SIFT1M-shaped corpus of `chip_smoke.py` (seed 0),
builds the kernels, and runs phase 2: every kernel row held against its
plain version and timed. Prints the phase's own log lines, then one JSON
line: the tree and the event-timed milliseconds of each row whose name
contains `--match` (every row by default). With `--device-time` every time
of the phase is the profiler's device time instead: kernels of a few tens
of microseconds, launched back to back from Python, read the host's launch
rate on CUDA events. Run the two checkouts in separate processes within one
call, alternating (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True, help="checkout whose chip_smoke.py to run")
    ap.add_argument("--match", default="", help="keep the rows whose name contains this")
    ap.add_argument("--device-time", action="store_true", help="time rows by device time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_rows: torch.cuda.is_available() is False; this script needs a card")
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import chip_smoke as cs
    from repro_torch.configs.grnnd_paper import SIFT1M
    from repro_torch.core import Draws
    from repro_torch.data import synthetic

    cs.phase_device()
    if args.device_time:
        cs.cuda_ms = cs.device_ms
    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(cs.SEED)
    x = synthetic.make_preset(g, "sift-like", SIFT1M.n)
    queries = synthetic.queries_from(g, x, SIFT1M.n_queries)
    rows = cs.phase_kernels(x, queries, Draws(cs.SEED + 1, dev), SIFT1M.build)
    ms = {r["name"]: r["ms"] for r in rows if args.match in r["name"]}
    clock = "device" if args.device_time else "event"
    print(json.dumps({"tree": str(tree), "clock": clock, "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
