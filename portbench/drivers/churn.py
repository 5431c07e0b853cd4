"""Closed loop of streaming churn on the dynamic index (`repro_torch.core.dynamic.DynamicIndex`).

Set-up draws `base` + `stream_batches` x `batch` rows of the configuration's
data (the same set for every seed, in the seed's order): the first `base`
are the base corpus, the rest the stream of new rows. It builds the base graph
with the program, wraps it in a `DynamicIndex` of the configuration's
`dynamic` settings, and runs one insert and its delete as the warm-up. Each
unit of the window inserts the next batch of the stream and then deletes
the `batch` oldest live labels (a rolling retention window: the live count
stays `base`); compaction runs inside `delete` at the index's own
threshold. The stream is used in turn; a row comes back only long after
its earlier label was deleted.

After the window the program searches the index (the traffic's `ef`,
visited set, rescore on) for queries near the live rows, and the check
holds it to the exact neighbours among the live rows that the benchmark
itself keeps: no deleted label may come back, and every insert must have
returned the next labels in order.
"""

from __future__ import annotations

import torch

from portbench import data
from portbench.reference import judge as J
from portbench.reference import knn
from repro_torch.core import grnnd
from repro_torch.core.draws import Draws
from repro_torch.core.dynamic import DynamicConfig, DynamicIndex


class State:
    pass


def _batch_rows(st, i: int) -> torch.Tensor:
    lo = (i % st.n_batches) * st.b
    return st.stream[lo : lo + st.b]


def _step(run, st) -> None:
    """Insert the next batch, then delete the oldest live batch."""
    dev = run.device
    with run.span("insert"):
        labels = st.index.insert(_batch_rows(st, st.inserted))
        run.sync()
    want = torch.arange(st.next_label, st.next_label + st.b, device=dev)
    if labels.shape != want.shape:  # labels missing or extra: each counts
        st.label_errors.append(torch.tensor(abs(labels.numel() - st.b) + st.b))
    else:
        st.label_errors.append((labels.to(dev) != want).sum())
    with run.span("delete"):
        st.index.delete(torch.arange(st.lo, st.lo + st.b, device=dev))
        run.sync()
    st.next_label += st.b
    st.lo += st.b
    st.inserted += 1


def prepare(run):
    cfg, t, dev = run.config, run.traffic, run.device
    st = State()
    st.base, st.b, st.n_batches = t["base"], t["batch"], t["stream_batches"]
    rows = data.corpus(run.seed, cfg["data"], cfg["d"], st.base + st.n_batches * st.b, dev)
    st.x_base, st.stream = rows[: st.base], rows[st.base :]
    bcfg = grnnd.GRNNDConfig(**cfg["build"])
    pool = grnnd.build_graph(st.x_base, bcfg, draws=Draws(data.sub_seed(run.seed, 2, 0), dev),
                             device=dev)
    st.index = DynamicIndex(st.x_base, pool, DynamicConfig(**cfg["dynamic"]),
                            draws=Draws(data.sub_seed(run.seed, 5), dev), device=dev)
    del pool
    st.next_label, st.lo, st.inserted = st.base, 0, 0
    st.label_errors = []
    _step(run, st)  # the warm-up: one insert and its delete
    return st


def unit(run, st) -> None:
    _step(run, st)
    run.add("vectors_inserted", st.b)
    run.add("batches", 1)


def live_rows(st) -> torch.Tensor:
    """The vectors of the live labels [lo, next_label), in label order, from
    the benchmark's own copy of what it inserted."""
    labels = torch.arange(st.lo, st.next_label, device=st.stream.device)
    from_base = labels < st.base
    j = (labels - st.base).clamp_min(0) % (st.n_batches * st.b)
    rows = st.stream[j]
    rows[from_base] = st.x_base[labels[from_base]]
    return rows


def _queries(run, st, live: torch.Tensor) -> torch.Tensor:
    return data.queries_near(data.generator(run.seed, run.device, 1), run.config["data"], live,
                             run.config["n_queries"])


def answers(run, st) -> dict:
    t = run.traffic
    st.live = live_rows(st)
    st.queries = _queries(run, st, st.live)
    res = st.index.search(st.queries, k=run.config["k"], ef=t["ef"], visited=t["visited"])
    out = {
        "labels": res.ids,
        "dists": res.dists,
        "label_errors": int(sum(int(e) for e in st.label_errors)),
        "n_live": st.index.n_live,
    }
    st.index = None
    return out


def control(run, st) -> dict:
    st.live = live_rows(st)
    st.queries = _queries(run, st, st.live)
    ids, d = knn.exact_knn_bf16(st.live, st.queries, run.config["k"])
    st.index = None
    return {"labels": ids + st.lo, "dists": d.float(), "label_errors": 0,
            "n_live": st.next_label - st.lo}


def judge(run, st, ans) -> dict:
    labels = ans["labels"].long()
    deleted = int(((labels >= 0) & (labels < st.lo)).sum())
    rows = torch.where((labels >= st.lo) & (labels < st.next_label), labels - st.lo, -1)
    truth = knn.exact_knn(st.live, st.queries, run.config["k"])[0]
    nums, _ = J.result_numbers(st.live, st.queries, rows, ans["dists"], truth)
    state_errors = ans["label_errors"] + abs(ans["n_live"] - (st.next_label - st.lo))
    return {"deleted_returned": deleted, "index_state_errors": state_errors, **nums}
