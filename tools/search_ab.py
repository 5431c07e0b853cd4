#!/usr/bin/env python3
"""Time the port's static hashed search in one checkout, for parent / change
comparisons on one card.

    python3 tools/search_ab.py --tree path/to/checkout [--reps 5] [--queries N] [--save out.pt]

Imports `repro_torch` from `<tree>/src` (kernels build into that tree's
`build/`), draws the SIFT1M-shaped corpus of `chip_smoke.py`'s main path
(`sift-like`, n = 10^6, 10,000 queries or `--queries`, seed 0), builds it
with the SIFT1M config, runs one warm-up search and then `--reps` hashed
searches at ef 64, each ended by a sync. Prints one JSON line: the tree, the
seconds of each search, their median, the median QPS, the mean `n_expanded`
(equal across trees when both do the same work) and the program's counts
over the warm-up search (`repro_torch.trace.counts()`: launches, host syncs,
tallies); then the device time of
`search_expand` (B3) over one more search under torch.profiler, and the
seconds of three runs of the main path's ground truth (`brute_force_knn`
of the 10,000 queries: ten launches of B5). Run it alternately on both
checkouts, in separate processes: the search is host-bound, and the host's
speed drifts within a call. `--save` writes the warm-up search's ids, dists
and n_expanded (`torch.save`), for a bitwise comparison of two trees.
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
    ap.add_argument("--queries", type=int, default=None, help="queries a search (SIFT1M's 10,000)")
    ap.add_argument("--save", default=None, help="torch.save the warm-up search's result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("search_ab: torch.cuda.is_available() is False; this script needs a card")
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch import trace
    from repro_torch.configs.grnnd_paper import SIFT1M
    from repro_torch.core import Draws, brute_force_knn, build_graph, search
    from repro_torch.data import synthetic

    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(SEED)
    x = synthetic.make_preset(g, "sift-like", SIFT1M.n)
    queries = synthetic.queries_from(g, x, args.queries or SIFT1M.n_queries)
    pool = build_graph(x, SIFT1M.build, draws=Draws(SEED + 2, dev), device=dev)

    def run():
        return search(x, pool.ids, queries, k=10, ef=64, visited="hashed", device=dev)

    before = trace.counts()
    res = run()
    torch.cuda.synchronize()
    after = trace.counts()
    counted = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    if args.save:
        torch.save({"ids": res.ids.cpu(), "dists": res.dists.cpu(),
                    "n_expanded": res.n_expanded.cpu()}, args.save)
    secs = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    b3 = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and "search_expand" in e.key
    ]
    gt_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        brute_force_knn(x, queries, 10, device=dev)
        torch.cuda.synchronize()
        gt_s.append(time.perf_counter() - t0)
    print(
        json.dumps(
            {
                "tree": str(tree),
                "search_s": secs,
                "median_s": med,
                "median_qps": queries.shape[0] / med,
                "mean_n_expanded": float(res.n_expanded.float().mean()),
                "counts": counted,
                "search_expand_device_ms": sum(e.self_device_time_total for e in b3) / 1e3,
                "search_expand_launches": sum(e.count for e in b3),
                "ground_truth_s": gt_s,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
