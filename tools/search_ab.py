#!/usr/bin/env python3
"""Time the port's static hashed search in one checkout, for parent / change
comparisons on one card.

    python3 tools/search_ab.py --tree path/to/checkout [--reps 5]

Imports `repro_torch` from `<tree>/src` (kernels build into that tree's
`build/`), draws the SIFT1M-shaped corpus of `chip_smoke.py`'s main path
(`sift-like`, n = 10^6, 10,000 queries, seed 0), builds it with the SIFT1M
config, runs one warm-up search and then `--reps` hashed searches at ef 64,
each ended by a sync. Prints one JSON line: the tree, the seconds of each
search, their median, the median QPS, and the mean `n_expanded` (equal
across trees when both do the same work). Run it alternately on both
checkouts, in separate processes: the search is host-bound, and the host's
speed drifts within a call.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

SEED = 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True, help="checkout whose src/repro_torch to time")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("search_ab: torch.cuda.is_available() is False; this script needs a card")
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.configs.grnnd_paper import SIFT1M
    from repro_torch.core import Draws, build_graph, search
    from repro_torch.data import synthetic

    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(SEED)
    x = synthetic.make_preset(g, "sift-like", SIFT1M.n)
    queries = synthetic.queries_from(g, x, SIFT1M.n_queries)
    pool = build_graph(x, SIFT1M.build, draws=Draws(SEED + 2, dev), device=dev)

    def run():
        return search(x, pool.ids, queries, k=10, ef=64, visited="hashed", device=dev)

    res = run()
    secs = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    print(
        json.dumps(
            {
                "tree": str(tree),
                "search_s": secs,
                "median_s": med,
                "median_qps": queries.shape[0] / med,
                "mean_n_expanded": float(res.n_expanded.float().mean()),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
