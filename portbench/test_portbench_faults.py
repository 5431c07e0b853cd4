"""A run whose timed path is broken underneath is refused: once for each
fault a cell can have (a step that returns its state unchanged, half of the
batch left out, an answer altered where it is produced; the cells run on one
chip, so no exchange between chips can be left out). Tiny sizes on the CPU;
the look for a card is skipped."""

from __future__ import annotations

import importlib

import pytest
import torch

from portbench import harness, tiny
from repro_torch.core import dynamic, grnnd
from repro_torch.core.search import SearchResult

# the package `repro_torch.core` exports a function named `search`
search_mod = importlib.import_module("repro_torch.core.search")
SEED = 2**31 + 13


def run(cell: str) -> dict:
    return harness.execute(harness.Run(tiny.cell(cell), SEED, 0.3, False, "cpu"))


def _unchanged_round(x, pool, draws, cfg, t1=0, t2=0):
    return pool


def _reverse_unchanged(pool, cfg, rho=None):
    return pool


def _altered_build(inner):
    def build(*a, **k):
        pool = inner(*a, **k)
        pool.dists[7, 0] *= 1.01
        return pool
    return build


def _half_search(inner):
    def search(x, graph_ids, queries, **k):
        half = queries.shape[0] // 2
        res = inner(x, graph_ids, queries[:half], **k)
        pad = torch.full((queries.shape[0] - half, res.ids.shape[1]), -1, dtype=res.ids.dtype)
        dists = torch.cat([res.dists, torch.full(pad.shape, torch.inf)])
        return SearchResult(torch.cat([res.ids, pad]), dists, res.n_expanded)
    return search


def _altered_search(inner):
    def search(*a, **k):
        res = inner(*a, **k)
        ids = res.ids.clone()
        ids[0, 0] = ids[0, -1]
        return SearchResult(ids, res.dists, res.n_expanded)
    return search


def _half_insert(inner):
    def insert(self, xs, *a, **k):
        return inner(self, xs[: xs.shape[0] // 2], *a, **k)
    return insert


def _altered_index_search(inner):
    def search(self, *a, **k):
        res = inner(self, *a, **k)
        return SearchResult(res.ids, res.dists * 1.01, res.n_expanded)
    return search


FAULTS = {
    # a step that returns its state unchanged
    "build/unchanged": ("sift1m.build", [(grnnd, "update_round", lambda f: _unchanged_round),
                                         (grnnd, "reverse_edge_round",
                                          lambda f: _reverse_unchanged)]),
    "churn/unchanged": ("sift1m.churn", [(dynamic.DynamicIndex, "delete",
                                          lambda f: lambda self, labels: 0)]),
    # half of the batch left out
    "search/half": ("sift1m.search", [(search_mod, "search", _half_search)]),
    "churn/half": ("sift1m.churn", [(dynamic.DynamicIndex, "insert", _half_insert)]),
    # an answer altered where it is produced
    "build/altered": ("sift1m.build", [(grnnd, "build_graph", _altered_build)]),
    "search/altered": ("sift1m.search", [(search_mod, "search", _altered_search)]),
    "churn/altered": ("sift1m.churn", [(dynamic.DynamicIndex, "search", _altered_index_search)]),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_refused(fault, monkeypatch):
    cell, patches = FAULTS[fault]
    for owner, attr, make in patches:
        monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    out = run(cell)
    assert not out["correct"], out["checks"]
    assert out["failed"] == out["attempted"]
