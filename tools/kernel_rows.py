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
rate on CUDA events. With `--digest` the line also holds a SHA-256 of
`gather_sqdist`'s output at each storage rung on the re-base's pairs (each
of 900,000 owners repeated 48 times beside random neighbors, seed 0), in
order and shuffled: equal digests of two checkouts mean bitwise-equal
kernels there. With `--inserts` the rows are instead the visited-insert rows
of phase 4: the SIFT1M build of `chip_smoke.py` (seed 2), then every insert
of one hashed search at ef 64, 128 and 512, replayed and timed. Run the two
checkouts in separate processes within one call, alternating (A, B, B, A).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True, help="checkout whose chip_smoke.py to run")
    ap.add_argument("--match", default="", help="keep the rows whose name contains this")
    ap.add_argument("--device-time", action="store_true", help="time rows by device time")
    ap.add_argument("--digest", action="store_true", help="hash gather_sqdist's re-base output")
    ap.add_argument("--inserts", action="store_true", help="the visited-insert rows only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_rows: torch.cuda.is_available() is False; this script needs a card")
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import chip_smoke as cs
    from repro_torch.configs.grnnd_paper import SIFT1M
    from repro_torch.core import Draws, build_graph
    from repro_torch.data import synthetic

    cs.phase_device()
    if args.device_time:
        cs.cuda_ms = cs.device_ms
    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(cs.SEED)
    x = synthetic.make_preset(g, "sift-like", SIFT1M.n)
    queries = synthetic.queries_from(g, x, SIFT1M.n_queries)
    if args.inserts:
        pool = build_graph(x, SIFT1M.build, draws=Draws(cs.SEED + 2, dev), device=dev)
        rows = []
        cs.insert_rows(x, pool.ids, queries, rows)
    else:
        rows = cs.phase_kernels(x, queries, Draws(cs.SEED + 1, dev), SIFT1M.build)
    ms = {r["name"]: r["ms"] for r in rows if args.match in r["name"]}
    clock = "device" if args.device_time else "event"
    line = {"tree": str(tree), "clock": clock, "ms": ms}
    if args.digest:
        line["digest"] = gather_digests(x, dev)
    print(json.dumps(line), flush=True)


def gather_digests(x, dev) -> dict:
    """SHA-256 (first 16 hex digits) of `gather_sqdist` on the re-base's
    pairs at each rung, in order and under one shuffle of the pairs."""
    from repro_torch.core import encode
    from repro_torch.kernels.gather_l2 import gather_sqdist

    g = torch.Generator(dev).manual_seed(0)
    n, r = 900_000, 48
    ni = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(r)
    nj = torch.randint(0, x.shape[0], (n * r,), generator=g, device=dev, dtype=torch.int32)
    perm = torch.randperm(n * r, generator=g, device=dev)
    out = {}
    for rung in ("fp32", "bf16", "int8"):
        data, sc, of = encode(x, rung)
        for order, a, b in (("runs", ni, nj), ("shuffled", ni[perm], nj[perm])):
            got = gather_sqdist(data, a.contiguous(), b.contiguous(), sc, of).cpu().numpy()
            out[f"{rung}/{order}"] = hashlib.sha256(got.tobytes()).hexdigest()[:16]
    return out


if __name__ == "__main__":
    main()
