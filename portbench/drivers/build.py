"""Closed loop of whole GRNND builds (`repro_torch.core.grnnd.build_graph`).

Set-up draws the configuration's corpus and recall queries on the device
and runs one whole build as the warm-up. The window runs builds of that
corpus back to back, each with fresh `Draws` and each ended by a wait for
the device, and keeps every pool it builds. After the window the program
searches the window's first graph for the recall queries (the traffic's
`ef` and visited set): the first, so that which graph is searched does not
depend on how many builds the window held. The check holds every pool of
the window, every slot, to the exact distances, and the search to the
exact neighbours.

The corpus, the builds' draws and the recall queries are the
configuration's own, drawn from the data's seed, and `--seed` orders the
queries: every run does the same work and reads the same recall (a seed's
own draws moved recall by up to 1% between seeds, measured on one H100).
"""

from __future__ import annotations

import torch

from portbench import data
from portbench.reference import judge as J
from portbench.reference import knn
from portbench.rooflines import counts
from repro_torch.core import grnnd
from repro_torch.core.search import search
from repro_torch.core.draws import Draws


class State:
    pass


def _draws(run, i: int) -> Draws:
    return Draws(data.sub_seed(run.config["data"]["seed"], 2, i), run.device)


def prepare(run):
    cfg, dev = run.config, run.device
    fixed = cfg["data"]["seed"]
    st = State()
    st.x = data.corpus(fixed, cfg["data"], cfg["d"], cfg["n"], dev)
    q = data.queries_near(data.generator(fixed, dev, 1), cfg["data"], st.x, cfg["n_queries"])
    st.queries = q[torch.randperm(q.shape[0], generator=data.generator(run.seed, dev, 7),
                                  device=dev)]
    st.cfg = grnnd.GRNNDConfig(**cfg["build"])
    st.pools = []
    grnnd.build_graph(st.x, st.cfg, draws=_draws(run, 0), device=dev)  # the warm-up
    return st


def unit(run, st) -> None:
    with run.span("build"):
        pool = grnnd.build_graph(st.x, st.cfg, draws=_draws(run, len(st.pools) + 1),
                                 device=run.device)
        run.sync()
    st.pools.append(pool)
    run.add("builds", 1)


def _rng_round_bounds(run, st) -> None:
    """The frozen B1 count of the window's launches: one a round, over C
    rows (the configuration's chunk where the program chunks, else all N),
    reading the distinct rows the last pool names."""
    n, c = run.config["n"], st.cfg.chunk_size
    chunk = c if c is not None and n % c == 0 and c < n else n
    last = st.pools[-1].ids
    uniq = int(torch.unique(last[last >= 0]).numel()) * chunk // n
    launches = len(st.pools) * st.cfg.t1 * st.cfg.t2 * (n // chunk)
    nbytes, ops = counts.rng_round(chunk, st.cfg.r, st.cfg.pairs_per_vertex, run.config["d"], uniq)
    run.rooflines["rng_round"] = {"bound_s": launches * counts.bound_s(nbytes, ops),
                                  "launches": launches}


def answers(run, st) -> dict:
    if run.trace:
        _rng_round_bounds(run, st)
    t = run.traffic
    res = search(st.x, st.pools[0].ids, st.queries, k=run.config["k"], ef=t["ef"],
                 visited=t["visited"], device=run.device)
    return {"pools": [(p.ids, p.dists) for p in st.pools], "ids": res.ids, "dists": res.dists}


def control(run, st) -> dict:
    ids, d = knn.exact_knn_bf16(st.x, st.queries, run.config["k"])
    pools = [(p.ids, knn.pool_sqdist(st.x, p.ids, "bf16").float()) for p in st.pools]
    return {"pools": pools, "ids": ids, "dists": d.float()}


def judge(run, st, ans) -> dict:
    bad, err = 0, 0.0
    for ids, dists in ans["pools"]:
        nums = J.pool_numbers(st.x, ids, dists)
        bad += nums["pool_bad_entries"]
        err = max(err, nums["pool_dist_err"])
    truth = knn.exact_knn(st.x, st.queries, run.config["k"])[0]
    nums, _ = J.result_numbers(st.x, st.queries, ans["ids"], ans["dists"], truth)
    return {"pool_bad_entries": bad, "pool_dist_err": err, **nums}
