"""Shared pieces of the port's multi-rank tests on gloo: launching the ranks
of `_torch_comm_worker.py`, and the inputs both the ranks and the tests
draw from numpy seeds."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
RANK_TIMEOUT = 240  # seconds for all ranks of one launch

# compressed_psum_mean's cases: name -> (shape, block). Sizes that are and
# are not a multiple of the block; "zero" cases hold an all-zero first block
# on every rank (the 1e-12 scale clamp)
COMP_CASES = {
    "ragged-256": ((37, 29), 256),
    "ragged-128": ((37, 29), 128),
    "whole-256": ((4, 256), 256),
    "whole-128": ((3, 128), 128),
    "zero-256": ((2, 300), 256),
    "zero-128": ((5, 77), 128),
    "reference-64": ((64,), 256),  # the reference test's (4, 64): one row a rank
}

# the expert-parallel MoE variants of the reference's test_moe_ep.py:
# name -> (n_experts, top_k, n_shared_experts)
MOE_VARIANTS = {"plain": (8, 2, 0), "shared": (8, 2, 1), "finegrained": (16, 4, 2)}
MOE_X_SHAPE = (4, 16, 32)
MOE_CAPACITY = 16.0          # no drops
PERMUTE_CAPACITY = 0.5       # _permute_ffn is also held where it drops
MOE_MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}  # world -> (data, model) meshes

# the compressed train step: reduced gemma3-1b, fp32, rank r trains on the
# pipeline's batch of step r
STEP_ARCH, STEP_BATCH, STEP_SEQ = "gemma3-1b", 2, 16
STEP_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)

# the FSDP train step: reduced gemma3-1b (dense), fp32, the global batch on
# every rank, sharded over the data axis of a (2, 2) mesh
FSDP_ARCH, FSDP_BATCH, FSDP_SEQ, FSDP_MESH = "gemma3-1b", 4, 16, (2, 2)
# the further DTensor paths on the same mesh: name -> arch. "moe" takes the
# expert-parallel block under FSDP placements, "ssm" the SSD scan; the MoE's
# capacity leaves no drops, so both paths route alike
FSDP_CASES = {"moe": "deepseek-moe-16b", "ssm": "mamba2-130m"}
# one decode step of reduced FSDP_ARCH on a cache of DECODE_SMAX positions,
# placed by the cache rules (batch over data, sequence over model): each row
# at its own position, in both sequence blocks
DECODE_SMAX, DECODE_POS = 32, (16, 3, 21, 9)

# placements: (mesh shape, mesh axes, spec, tensor shape)
PLACEMENTS = (
    ((2, 2), ("data", "model"), (), (8, 12)),
    ((2, 2), ("data", "model"), (None, "model"), (8, 12)),
    ((2, 2), ("data", "model"), ("model", ("data",)), (8, 12)),
    ((2, 2), ("data", "model"), (("data", "model"), None), (8, 12)),
    ((1, 2, 2), ("pod", "data", "model"), (("pod", "data"), "model"), (8, 12)),
    ((1, 2, 2), ("pod", "data", "model"), (None, None, "model"), (2, 3, 4)),
)


def comp_input(case: str, rank: int) -> np.ndarray:
    """One rank's fp32 input of a compression case."""
    shape, block = COMP_CASES[case]
    rng = np.random.default_rng([list(COMP_CASES).index(case), rank])
    x = (rng.standard_normal(shape) * (1.0 + rank)).astype(np.float32)
    if case.startswith("zero"):
        x.reshape(-1)[:block] = 0.0
    return x


def moe_cfg_kwargs(variant: str, capacity: float) -> dict:
    """The reference test's config fields (both packages' ArchConfig)."""
    e, k, shared = MOE_VARIANTS[variant]
    return dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_head=8, d_ff=64, vocab=64, n_experts=e, top_k=k, d_expert=16,
                n_shared_experts=shared, moe_capacity_factor=capacity)


def fsdp_case_cfg(case: str):
    """The reduced config of an `FSDP_CASES` case (the port's ArchConfig)."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced

    cfg = reduced(get_arch(FSDP_CASES[case]))
    return dataclasses.replace(cfg, moe_capacity_factor=MOE_CAPACITY) if cfg.n_experts else cfg


def moe_x() -> np.ndarray:
    return np.random.default_rng(1).standard_normal(MOE_X_SHAPE).astype(np.float32)


def mesh_name(shape) -> str:
    return "x".join(str(v) for v in shape)


def run_ranks(suite: str, world: int, out: Path) -> list[dict]:
    """Start `world` ranks of the worker's `suite` (a file:// rendezvous in
    `out`, one intra-op thread a rank), wait for all of them, and return
    each rank's arrays (its npz as a dict)."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, str(HERE / "_torch_comm_worker.py"), suite, str(r), str(world),
             str(out / "init"), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for p2 in procs:
                p2.kill()
                p2.communicate()
            pytest.fail(f"{suite} at world {world}: a rank did not finish in {RANK_TIMEOUT} s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


def verdicts(out: Path, world: int) -> list[dict]:
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
