"""Tiny stand-ins of the cells, for the CPU tests: each cell's files as
`BENCHMARK.json` names them, with the sizes cut to what a test holds."""

from __future__ import annotations

import json

from portbench import harness

CONFIG = {
    "n": 3000,
    "d": 16,
    "n_queries": 200,
    "build": {"s": 8, "r": 16, "t1": 2, "t2": 3, "rho": 0.6, "pairs_per_vertex": 16},
    "dynamic": {"precision": "int8", "seed_k": 8, "seed_ef": 32, "refine_rounds": 2,
                "pairs_per_vertex": 16, "compact_threshold": 0.25},
    "data": {"seed": 0, "n_clusters": 16, "cluster_std": 0.15, "query_noise": 0.05},
}
TRAFFIC = {
    "search": {"batch": 300},
    "churn": {"base": 2500, "batch": 200, "stream_batches": 8},
}


def spec(held_out: bool = False) -> dict:
    """`BENCHMARK.json`; with `held_out`, also the entries of the cells held
    out of it (`held_out.json`), whose files the tests still run."""
    s = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    if held_out:
        extra = json.loads((harness.BENCH / "held_out.json").read_text())
        for key in ("workloads", "end_to_end", "per_layer"):
            s[key] = s[key] + extra[key]
    return s


def cell(name: str) -> harness.Cell:
    """Cell `name` with its configuration and traffic cut to the tiny sizes."""
    c = harness.Cell(spec(held_out=True), name)
    c.config = {**c.config, **CONFIG}
    c.traffic = {**c.traffic, **TRAFFIC.get(c.traffic["driver"], {})}
    return c
