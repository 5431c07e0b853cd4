"""Closed loop of whole GRNND builds at a corpus size whose exact k-NN needs
blocks sized from N (`repro_torch.core.grnnd.build_graph`).

The work is `build.py`'s, and so are its set-up, its unit and its answers,
by import: the configuration's corpus and queries drawn on the device, one
whole build as the warm-up, builds back to back with fresh `Draws` in the
window, every pool kept, the window's first graph searched for the recall
queries after it. Beside each build the program's `pools/slices` tally is
read into `run.counters` (where the program has it). The check differs in
one place: the exact neighbours come from `reference/knn_big.py`, whose
blocks of queries keep the (block, N) candidate matrices under a fixed size,
since `knn.exact_knn`'s would not fit on the card at 10^7 rows.
"""

from __future__ import annotations

from portbench.drivers import build
from portbench.reference import judge as J
from portbench.reference import knn, knn_big
from repro_torch import trace

SLICES = "pools/slices"

prepare, answers = build.prepare, build.answers


def unit(run, st) -> None:
    before = trace.counts().get(SLICES)
    build.unit(run, st)
    if before is not None:
        run.add(SLICES, trace.counts()[SLICES] - before, run.counters)


def control(run, st) -> dict:
    ids, d = knn_big.exact_knn_bf16(st.x, st.queries, run.config["k"])
    pools = [(p.ids, knn.pool_sqdist(st.x, p.ids, "bf16").float()) for p in st.pools]
    return {"pools": pools, "ids": ids, "dists": d.float()}


def judge(run, st, ans) -> dict:
    bad, err = 0, 0.0
    for ids, dists in ans["pools"]:
        nums = J.pool_numbers(st.x, ids, dists)
        bad += nums["pool_bad_entries"]
        err = max(err, nums["pool_dist_err"])
    truth = knn_big.exact_knn(st.x, st.queries, run.config["k"])[0]
    nums, _ = J.result_numbers(st.x, st.queries, ans["ids"], ans["dists"], truth)
    return {"pool_bad_entries": bad, "pool_dist_err": err, **nums}
