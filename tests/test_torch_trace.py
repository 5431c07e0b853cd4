"""repro_torch.trace: the spans and host-sync counters of the build rounds and
the beam loop, on the CPU.

With no profiler recording, `span()` is one shared null context. Under
`torch.profiler` a tiny build records each span as often as its rounds
run, nested as `trace.SPANS` documents; a tiny hashed search, replicated
or corpus-sharded, records one `search.step` a loop iteration, the last
(breaking) one included, beside as many passes of the frontier's counted
sync. Outputs are bitwise the same with the profiler on and off.
"""

import collections
import contextlib

import pytest
import torch

from repro_torch import trace
from repro_torch.core import Draws, GRNNDConfig, build_graph, corpus_shard, pools, search
from repro_torch.kernels import _build

torch.set_num_threads(1)

CFG = dict(s=8, r=16, t1=3, t2=2, pairs_per_vertex=16, chunk_size=200)


def _data():
    g = torch.Generator().manual_seed(5)
    return torch.randn(600, 8, generator=g), torch.randn(24, 8, generator=g)


def _build_graph(x, order):
    return build_graph(x, GRNNDConfig(**CFG, order=order), draws=Draws(2, "cpu"), device="cpu")


def _recorded(fn):
    """(fn(), {(span, innermost enclosing span or None): times recorded},
    {sync site: passes}) with fn run under the CPU profiler."""
    before = trace.counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    after = trace.counts()
    spans = sorted(
        ((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
         for e in prof.profiler.kineto_results.events() if e.name() in trace.SPANS),
        key=lambda s: (s[1], -s[2]),
    )
    stack, seen = [], collections.Counter()
    for name, a, b in spans:
        while stack and stack[-1][2] <= a:
            stack.pop()
        seen[name, stack[-1][0] if stack else None] += 1
        stack.append((name, a, b))
    syncs = {
        k[len("host_sync/") :]: after[k] - before[k] for k in after if k.startswith("host_sync/")
    }
    return out, seen, syncs


def test_span_is_the_shared_null_context_with_the_profiler_off():
    assert not torch.autograd._profiler_enabled()
    ctxs = [trace.span(name) for name in trace.SPANS]
    assert all(c is ctxs[0] for c in ctxs) and isinstance(ctxs[0], contextlib.nullcontext)
    _, seen, _ = _recorded(lambda: None)
    assert not seen


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="unknown span"):
        trace.span("unknown")
    with pytest.raises(KeyError):
        trace.count("unknown")
    with pytest.raises(KeyError):
        trace.tally("unknown")


def test_counts_snapshot_launches_and_syncs(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", {"topr_merge": 3, "search_expand/int8+valid": 2})
    got = trace.counts()
    assert got["launch/topr_merge"] == 3 and got["launch/search_expand/int8+valid"] == 2
    assert {k for k in got if k.startswith("host_sync/")} == {f"host_sync/{s}" for s in trace.SYNCS}
    assert set(trace.TALLIES) <= set(got)
    got["launch/topr_merge"] = 0  # a snapshot, not a view
    assert trace.counts()["launch/topr_merge"] == 3


@pytest.mark.parametrize("order", ["disordered", "ascending"])
def test_build_records_its_rounds_nested(order):
    x, _ = _data()
    pool, seen, syncs = _recorded(lambda: _build_graph(x, order))
    t1, t2 = CFG["t1"], CFG["t2"]
    rounds, reverses = t1 * t2, t1 - 1
    assert seen == {
        ("grnnd.init", None): 1,  # its merge calls ops.topr_merge directly
        ("grnnd.round", None): rounds,
        ("grnnd.propagate", "grnnd.round"): rounds,
        ("pools.stage", "grnnd.round"): rounds,
        ("pools.merge", "grnnd.round"): rounds,
        ("grnnd.reverse", None): reverses,
        ("pools.stage", "grnnd.reverse"): reverses,
        ("pools.merge", "grnnd.reverse"): reverses,
    }
    # a staging counts its active requests
    assert syncs == {"search.frontier": 0, "search.entry": 0,
                     "grnnd.reverse": reverses, "pools.stage": rounds + reverses}
    plain = _build_graph(x, order)
    assert torch.equal(pool.ids, plain.ids) and torch.equal(pool.dists, plain.dists)


def test_sliced_staging_records_a_slice_span_each_and_one_sync(monkeypatch):
    """Past `pools.STAGE_BUDGET` active requests a staging records one
    `pools.slice` a slice staged, nested in `pools.stage`, beside a second
    pass of its counted sync and one `pools/slices` tally a slice; the pools
    are bitwise the unsliced build's."""
    x, _ = _data()
    plain = _build_graph(x, "disordered")
    monkeypatch.setattr(pools, "STAGE_BUDGET", 300)
    bounds, sliced = pools._slice_bounds, []
    monkeypatch.setattr(pools, "_slice_bounds", lambda *a: sliced.append(1) or bounds(*a))
    before = trace.counts()["pools/slices"]
    pool, seen, syncs = _recorded(lambda: _build_graph(x, "disordered"))
    slices = trace.counts()["pools/slices"] - before
    stagings = seen["pools.stage", "grnnd.round"] + seen["pools.stage", "grnnd.reverse"]
    assert stagings == CFG["t1"] * CFG["t2"] + CFG["t1"] - 1
    assert seen["pools.slice", "pools.stage"] == slices > len(sliced) > 0
    # every staging: its active requests counted; past 300 of them, its ranges read
    assert syncs["pools.stage"] == stagings + len(sliced)
    assert not {k for k in seen if k[0] == "pools.slice" and k[1] != "pools.stage"}
    assert torch.equal(pool.ids, plain.ids) and torch.equal(pool.dists, plain.dists)


@pytest.mark.parametrize("shards", [None, 2], ids=["replicated", "corpus-sharded"])
def test_hashed_search_records_one_step_a_sync(shards):
    """The corpus-sharded search (two shards in process) runs the same loop:
    the replicated search's spans and frontier counts, and no entry gather,
    its entry row being the index's. The loop reads each frontier test one
    iteration late, so its last step (the spare one) expands nothing."""
    x, q = _data()
    graph = _build_graph(x, "disordered").ids
    kw = dict(k=5, ef=16, visited="hashed")

    def replicated():
        return search(x, graph, q, device="cpu", **kw)

    index = None if shards is None else corpus_shard.shard(x, graph, shards, device="cpu")

    def run():
        return replicated() if index is None else index.search(q, **kw)

    res, seen, syncs = _recorded(run)
    steps = seen["search.step", None]
    expands = seen["search.expand", "search.step"]
    assert steps == syncs["search.frontier"] == expands + 1 > 1  # the last test finds none
    assert seen == {
        ("search.step", None): steps,
        ("search.frontier", "search.step"): steps,
        ("search.beam", "search.step"): 2 * expands,  # the selection, then the merge
        ("search.expand", "search.step"): expands,
        ("search.visited", "search.step"): expands,
    }
    assert syncs == {"search.frontier": steps,
                     "search.entry": int(shards is None), "grnnd.reverse": 0, "pools.stage": 0}
    if shards is not None:
        _, seen_rep, syncs_rep = _recorded(replicated)
        assert seen == seen_rep and syncs == {**syncs_rep, "search.entry": 0}
    plain = replicated()
    for a, b in zip(res, plain):
        assert torch.equal(a, b)
