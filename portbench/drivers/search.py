"""Closed loop, one client, of batched beam search (`repro_torch.core.search.search`).

Set-up draws the corpus, builds its graph with the program, draws
`distinct_batches` batches of `batch` queries and searches the first as the
warm-up. The window searches the batches in turn, so no batch follows
itself, each call ended by a wait for the device, and keeps every answer.
The check holds every answer of the window to the exact neighbours and
distances of its batch.

A call takes as many beam steps as the slowest of its queries needs, so a
batch's time follows its hardest query: batches drawn anew from each seed
read 13% apart (measured on one H100). So the corpus, its graph and the
query batches are the configuration's own, drawn from the data's seed,
and `--seed` orders them: the queries within each batch and the batch the
window starts with. Every run does the same work.
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
from repro_torch.kernels import _build, ops

KERNEL = "search_expand"


class State:
    pass


def _launches() -> int:
    """The program's launch count of every `search_expand` variant."""
    return sum(v for k, v in _build.LAUNCHES.items() if k.split("/")[0].split("+")[0] == KERNEL)


def _search(run, st, b: int):
    t = run.traffic
    return search(st.x, st.graph, st.batches[b], k=run.config["k"], ef=t["ef"],
                  visited=t["visited"], device=run.device)


def prepare(run):
    cfg, t, dev = run.config, run.traffic, run.device
    fixed = cfg["data"]["seed"]
    st = State()
    st.x = data.corpus(fixed, cfg["data"], cfg["d"], cfg["n"], dev)
    bcfg = grnnd.GRNNDConfig(**cfg["build"])
    st.graph = grnnd.build_graph(st.x, bcfg, draws=Draws(data.sub_seed(fixed, 2, 0), dev),
                                 device=dev).ids
    st.batches = []
    for b in range(t["distinct_batches"]):
        q = data.queries_near(data.generator(fixed, dev, 3, b), cfg["data"], st.x, t["batch"])
        order = torch.randperm(t["batch"], generator=data.generator(run.seed, dev, 7, b),
                               device=dev)
        st.batches.append(q[order])
    st.first = data.sub_seed(run.seed, 8) % len(st.batches)
    st.results = []  # (batch, ids, dists) of each call in the window
    st.launches = []  # search_expand launches of each call
    _search(run, st, st.first)  # the warm-up
    return st


def unit(run, st) -> None:
    b = (st.first + len(st.results)) % len(st.batches)
    before = _launches()
    with run.span("search"):
        res = _search(run, st, b)
        run.sync()
    st.launches.append(_launches() - before)
    st.results.append((b, res.ids, res.dists))
    run.add("queries", st.batches[b].shape[0])
    run.add("batches", 1)
    run.add(KERNEL, st.launches[-1], run.counters)


def _replayed_bound(run, st, b: int) -> tuple[float, int]:
    """(least seconds, launches) of `search_expand` over one search of batch
    b, run again after the window with each launch's inputs counted by the
    frozen count (the search is deterministic, so its launches are the
    window's)."""
    total = [0.0, 0]
    d = run.config["d"]
    inner = ops.search_expand

    def counted(x, queries, nbrs, table, *rest):
        live = nbrs[nbrs >= 0]
        nbytes, n_ops = counts.search_expand(queries.shape[0], nbrs.shape[1], table.shape[1], d,
                                             int(torch.unique(live).numel()), int(live.numel()))
        total[0] += counts.bound_s(nbytes, n_ops)
        total[1] += 1
        return inner(x, queries, nbrs, table, *rest)

    ops.search_expand = counted
    try:
        _search(run, st, b)
    finally:
        ops.search_expand = inner
    return total[0], total[1]


def answers(run, st) -> dict:
    if run.trace:
        per = {b: _replayed_bound(run, st, b) for b in {b for b, _, _ in st.results}}
        window = [per[b] for b, _, _ in st.results]
        if [n for _, n in window] == st.launches:
            run.rooflines[KERNEL] = {"bound_s": sum(s for s, _ in window),
                                     "launches": sum(st.launches)}
    st.graph = None
    return {"results": list(st.results)}


def control(run, st) -> dict:
    k = run.config["k"]
    ctl = {}
    for b, _, _ in st.results:
        if b not in ctl:
            ids, d = knn.exact_knn_bf16(st.x, st.batches[b], k)
            ctl[b] = (ids, d.float())
    st.graph = None
    return {"results": [(b, *ctl[b]) for b, _, _ in st.results]}


def judge(run, st, ans) -> dict:
    k = run.config["k"]
    truth = {}
    bad, err, recall = 0, 0.0, 0.0
    for b, ids, dists in ans["results"]:
        if b not in truth:
            truth[b] = knn.exact_knn(st.x, st.batches[b], k)[0]
        nums, _ = J.result_numbers(st.x, st.batches[b], ids, dists, truth[b])
        bad += nums["result_bad_entries"]
        err = max(err, nums["result_dist_err"])
        recall += nums["recall_at_10"]
    return {"result_bad_entries": bad, "result_dist_err": err,
            "recall_at_10": recall / len(ans["results"])}
