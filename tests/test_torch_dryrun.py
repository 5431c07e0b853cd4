"""The port's production-mesh dry-run (`repro_torch.launch.{specs,dryrun}`)
against the reference's (`repro.launch.{specs,dryrun}`), on the CPU.

  * `parallelism_policy` and `cell_is_applicable` are the reference's on
    every (arch x shape) and both production meshes (16 x 16, 2 x 16 x 16);
    `_extrapolate` gives the reference's output on the same records.
  * `RankCounter` maps each collective, c10d and functional, to the
    reference's HLO name and counts its result bytes (one hand-built case a
    name on a fake group, beside `CommDebugMode`'s count).
  * The GRNND cell (one rank's a2a build round) at the 4,4 and 2,4,4
    overrides, n = 2^20 at d = 8 (the exchange does not depend on d):
    all-to-all bytes and count equal the reference's `run_cell` (run in a
    subprocess over forced host devices), argument bytes the reference's
    less its 8-byte PRNG key, with x's bytes at d = 8.
  * One LM cell a policy (dp_only, tp, zero1, fsdp) at reduced() widths on
    fake 4,4 and 2,4,4 groups ends ok, its argument bytes the sum of the
    local bytes the sharding specs give; a dp_only cell's per-rank FLOPs x
    world equal the one-rank count; the 1- and 2-unit probes extrapolate to
    the whole-depth trace's cost and collectives, also past one CE chunk.
    Prefill and decode cells end ok, and long_500k is skipped where the
    reference skips it. The ranks are CPU ranks, asked for by name.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor.debug import CommDebugMode

from repro.configs import get_arch as jget_arch
from repro.configs.base import SHAPES as JSHAPES
from repro_torch.configs import get_arch, list_archs, reduced
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as SPEC
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import transformer as T

SRC = Path(__file__).resolve().parent.parent / "src"
PRODUCTION = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}
OVERRIDES = {"4,4": {"data": 4, "model": 4}, "2,4,4": {"pod": 2, "data": 4, "model": 4}}
GRNND_N, GRNND_D, GRNND_R = 1_048_576, 8, 48

# the reference's records: its GRNND cell at both overrides (forced host
# devices; its dryrun module forces 512 when imported) and `_extrapolate`
_REFERENCE = textwrap.dedent("""
    import json, os, sys
    from repro.launch.dryrun import _extrapolate, run_cell
    out = {"extrapolate": _extrapolate(*json.loads(sys.argv[1]))}
    for override in ("4,4", "2,4,4"):
        os.environ["REPRO_MESH_OVERRIDE"] = override
        res = run_cell("grnnd-ann", "build_1m_d128", "single")
        out[override] = {"status": res["status"], "collectives": res["collectives"],
                         "argument_size_bytes": res["memory"]["argument_size_bytes"]}
    print("RESULT" + json.dumps(out))
""")

P1 = {"cost": {"flops": 10.0, "bytes_accessed": 7.5, "transcendentals": 3.0},
      "collectives": {"all-gather": 100, "n_all-gather": 2, "total_bytes": 100}}
P2 = {"cost": {"flops": 16.0, "bytes_accessed": 9.0, "transcendentals": 3.0},
      "collectives": {"all-gather": 180, "n_all-gather": 3, "total_bytes": 180}}


@pytest.fixture(scope="module")
def reference():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps([P1, P2, 12])], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")][0]
    return json.loads(line[len("RESULT"):])


@pytest.fixture
def small_shapes(monkeypatch):
    """reduced() configs of `units` pattern units and small shapes of each
    kind, so a cell traces in seconds; the policy forced where asked."""
    def setup(units: int = 1, policy: str | None = None):
        def arch(name):
            cfg = get_arch(name)
            return reduced(cfg, n_layers=cfg.first_k_dense + units * len(cfg.layer_pattern))
        monkeypatch.setattr(SPEC, "get_arch", arch)
        monkeypatch.setattr(DR, "get_arch", arch)
        monkeypatch.setitem(SHAPES, "train_4k", ShapeConfig("train_4k", 64, 64, "train"))
        monkeypatch.setitem(SHAPES, "prefill_32k", ShapeConfig("prefill_32k", 128, 32, "prefill"))
        monkeypatch.setitem(SHAPES, "decode_32k", ShapeConfig("decode_32k", 256, 64, "decode"))
        monkeypatch.setitem(SHAPES, "long_500k", ShapeConfig("long_500k", 4096, 1, "decode"))
        if policy is not None:
            monkeypatch.setattr(SPEC, "parallelism_policy", lambda *a: policy)
    return setup


# ---------------------------------------------------------------------------
# the reference's decisions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_policy_and_applicability_match_reference(arch):
    from repro.launch import specs as JSPEC

    class FakeMesh:  # the reference test's: the policy reads mesh.shape only
        def __init__(self, shape):
            self.shape = shape

    for sizes in PRODUCTION.values():
        for shape in SHAPES:
            want = JSPEC.parallelism_policy(jget_arch(arch), JSHAPES[shape], FakeMesh(sizes))
            assert SPEC.parallelism_policy(get_arch(arch), SHAPES[shape], sizes) == want
    for shape in [*SHAPES, *SPEC.GRNND_SHAPES]:
        assert SPEC.cell_is_applicable(arch, shape) == JSPEC.cell_is_applicable(arch, shape)
        assert SPEC.cell_is_applicable("grnnd-ann", shape) \
            == JSPEC.cell_is_applicable("grnnd-ann", shape)
    assert SPEC.GRNND_SHAPES == JSPEC.GRNND_SHAPES


def test_extrapolate_matches_reference(reference):
    assert DR._extrapolate(P1, P2, 12) == reference["extrapolate"]


# ---------------------------------------------------------------------------
# collectives under their HLO names
# ---------------------------------------------------------------------------

WORLD = 4


def _collective(case: str):
    """(run, HLO name, result bytes) of one hand-built collective on a
    fake group of WORLD ranks."""
    t = torch.ones(8)  # 32 bytes
    group = dist.group.WORLD
    return {
        "c10d-all-gather": (lambda: dist.all_gather_into_tensor(torch.empty(32), t),
                            "all-gather", 128),
        "funcol-all-gather": (lambda: funcol.all_gather_tensor(t, 0, group).wait(),
                              "all-gather", 128),
        "c10d-all-reduce": (lambda: dist.all_reduce(t), "all-reduce", 32),
        "funcol-all-reduce": (lambda: funcol.all_reduce(t, "sum", group).wait(), "all-reduce", 32),
        "c10d-reduce-scatter": (lambda: dist.reduce_scatter_tensor(torch.empty(2), t),
                                "reduce-scatter", 8),
        "funcol-reduce-scatter": (lambda: funcol.reduce_scatter_tensor(t, "sum", 0, group).wait(),
                                  "reduce-scatter", 8),
        "c10d-all-to-all": (lambda: dist.all_to_all_single(torch.empty(8), t), "all-to-all", 32),
        "funcol-all-to-all": (lambda: funcol.all_to_all_single(t, None, None, group).wait(),
                              "all-to-all", 32),
        "c10d-collective-permute": (lambda: dist.recv(t, src=1), "collective-permute", 32),
    }[case]


@pytest.mark.parametrize("case", ["c10d-all-gather", "funcol-all-gather", "c10d-all-reduce",
                                  "funcol-all-reduce", "c10d-reduce-scatter",
                                  "funcol-reduce-scatter", "c10d-all-to-all", "funcol-all-to-all",
                                  "c10d-collective-permute"])
def test_collective_named_and_counted(case):
    with DR.fake_group(WORLD):
        run, name, nbytes = _collective(case)
        counter, comm = DR.RankCounter(), CommDebugMode()
        with comm, counter:
            run()
    rec = counter.collective_record()
    assert rec[name] == nbytes and rec[f"n_{name}"] == 1 and rec["total_bytes"] == nbytes
    assert sum(rec[f"n_{c}"] for c in DR.COLLECTIVES) == 1
    # CommDebugMode sees the same op (it leaves point-to-point receives out)
    assert comm.get_total_counts() == (0 if name == "collective-permute" else 1)


def test_dtensor_redistribution_is_counted_locally():
    """A DTensor all-gather counts the gathered (result) bytes, and the
    FLOPs of a product over a sharded batch are the local block's."""
    from torch.distributed.tensor import Replicate, Shard

    with DR.fake_group(WORLD):
        mesh = make_debug_mesh((WORLD,), ("data",), device="cpu")
        a = SH.with_shardings(torch.empty((64, 32), device="meta"), (("data",), None), mesh)
        w = SH.with_shardings(torch.empty((32, 16), device="meta"), (), mesh)
        counter = DR.RankCounter()
        with counter:
            y = a @ w
            full = a.redistribute(mesh, [Replicate()])
        assert y.placements == (Shard(0),) and full.to_local().shape == (64, 32)
    assert counter.flops == 2 * (64 // WORLD) * 32 * 16
    assert counter.collectives["all-gather"] == 64 * 32 * 4
    assert counter.n_collectives["all-gather"] == 1


# (the view, its spec before, its placements after): a run merged behind a
# sharded outer dim keeps the split, behind a sharded inner dim it is
# replicated; a split keeps it where the first part divides into the blocks
RESHAPES = [
    ((8, 4, 6), (32, 6), ("data", None, None), ("S0", "R")),
    ((8, 4, 6), (32, 6), (None, "data", None), ("R", "R")),
    ((8, 4, 8), (8, 32), (None, None, "model"), ("R", "R")),
    ((8, 4, 8), (8, 32), (None, "model", None), ("R", "S1")),
    ((8, 12), (8, 4, 3), (None, "model"), ("R", "S1")),
    ((8, 12), (8, 2, 6), (None, "model"), ("R", "R")),
    ((16, 12), (192,), (("data", "model"), None), ("S0", "S0")),
]


@pytest.mark.parametrize("case", range(len(RESHAPES)))
def test_reshape_keeps_the_splits_a_view_can(case):
    from torch.distributed.tensor import Replicate, Shard

    src, dst, spec, want = RESHAPES[case]
    with DR.fake_group(16):
        mesh = make_debug_mesh((4, 4), device="cpu")
        x = SH.with_shardings(torch.empty(src, device="meta"), spec, mesh)
        y = SH.reshape(x, dst)
    names = {"R": Replicate(), "S0": Shard(0), "S1": Shard(1)}
    assert tuple(y.shape) == dst and tuple(y.placements) == tuple(names[w] for w in want)


def test_einsum_on_dtensors_keeps_shapes_and_local_flops():
    """`sharding.einsum` on DTensors: torch.einsum's shape, and the local
    product's FLOPs where the weight's inner output dim is sharded (the
    attention projection of a model whose heads do not divide)."""
    with DR.fake_group(16):
        mesh = make_debug_mesh((4, 4), device="cpu")
        x = SH.with_shardings(torch.empty((8, 16, 32), device="meta"), ("data",), mesh)
        w = SH.with_shardings(torch.empty((32, 2, 64), device="meta"), (None, None, "model"),
                              mesh)
        counter = DR.RankCounter()
        with counter:
            y = SH.einsum("bsd,dhk->bshk", x, w)
    assert tuple(y.shape) == tuple(torch.einsum("bsd,dhk->bshk", torch.empty(8, 16, 32),
                                                torch.empty(32, 2, 64)).shape)
    assert counter.flops == 2 * (8 // 4) * 16 * 32 * 2 * 64 // 4


# ---------------------------------------------------------------------------
# the GRNND cell
# ---------------------------------------------------------------------------


def _grnnd_arg_bytes(n: int, d: int, world: int) -> int:
    """x replicated, this rank's ids and dists shards."""
    return n * d * 4 + 2 * (n // world) * GRNND_R * 4


@pytest.mark.parametrize("override", list(OVERRIDES))
def test_grnnd_cell_matches_reference(reference, override, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_MESH_OVERRIDE", override)
    world = math.prod(OVERRIDES[override].values())
    with DR.fake_group(world):
        mesh = make_production_mesh(device="cpu")
        fn, args = SPEC._grnnd_cell("build_1m_d128", mesh, device="cpu", d=GRNND_D)
        got = DR.trace_stats(fn, args)
    ref = reference[override]
    assert ref["status"] == "ok"
    for key in ("all-to-all", "n_all-to-all"):
        assert got["collectives"][key] == ref["collectives"][key], key
    assert got["collectives"]["n_all-to-all"] == 3
    cap = max(2 * (GRNND_N // world) * 48 // world, GRNND_R)
    assert got["collectives"]["all-to-all"] == 3 * world * cap * 4
    assert got["memory"]["argument_size_bytes"] == _grnnd_arg_bytes(GRNND_N, GRNND_D, world)
    assert ref["argument_size_bytes"] - 8 == _grnnd_arg_bytes(GRNND_N, 128, world)


# ---------------------------------------------------------------------------
# the LM cells
# ---------------------------------------------------------------------------

# one arch a policy, as chip_smoke.py's production cells
POLICY_ARCHS = {"dp_only": "mamba2-130m", "tp": "gemma2-2b", "zero1": "gemma3-27b",
                "fsdp": "qwen3-moe-235b-a22b"}


def _spec_bytes(shape, itemsize: int, spec, sizes) -> int:
    split = 1
    for entry in spec:
        for ax in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            split *= sizes[ax]
    return math.prod(shape) * itemsize // split


def _train_arg_bytes(cfg, policy: str, shape: ShapeConfig, sizes) -> int:
    """The parameters (fp32), AdamW's moments and step, and the batch, each
    leaf's bytes over the mesh axes its spec shards it over."""
    tp, fsdp = policy != "dp_only", policy == "fsdp"
    meta = T.init_params(cfg, device="meta")
    pspecs = SH.param_shardings(sizes, meta, tp=tp, fsdp=fsdp)
    ospecs = SH.param_shardings(sizes, meta, tp=tp, fsdp=policy in ("fsdp", "zero1"))
    total = 4  # the step
    for name, p in meta.named_parameters():
        total += _spec_bytes(p.shape, 4, pspecs[name], sizes)
        total += 2 * _spec_bytes(p.shape, 4, ospecs[name], sizes)
    axes = tuple(a for a in ("pod", "data", "model") if a in sizes) if policy == "dp_only" \
        else None
    batch = {"tokens": torch.empty((shape.global_batch, shape.seq_len), dtype=torch.int32)}
    bspec = SH.batch_shardings(sizes, batch, batch_axes=axes)["tokens"]
    return total + _spec_bytes(batch["tokens"].shape, 4, bspec, sizes)


@pytest.mark.parametrize("override", list(OVERRIDES))
@pytest.mark.parametrize("policy", list(POLICY_ARCHS))
def test_train_cell_per_policy(policy, override, small_shapes, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_MESH_OVERRIDE", override)
    probes = (policy, override) == ("fsdp", "4,4")  # as chip_smoke.py's fsdp cell
    small_shapes(units=3 if probes else 1, policy=policy)
    arch = POLICY_ARCHS[policy]
    res = DR.run_cell(arch, "train_4k", "single", cost_probes=probes, device="cpu",
                      mesh_device_type="cpu")
    assert res["status"] == "ok" and res["mesh_shape"] == OVERRIDES[override]
    cfg = SPEC.get_arch(arch)
    assert res["memory"]["argument_size_bytes"] == _train_arg_bytes(
        cfg, policy, SHAPES["train_4k"], OVERRIDES[override])
    assert res["cost"]["flops"] > 0 and res["memory"]["temp_size_bytes"] > 0
    assert res["cost"] == res["cost_raw_scanned"]  # the whole-depth trace
    if probes:  # the 1- and 2-unit probes extrapolate to the 3-unit trace
        assert res["cost_probes"] == res["cost"]
        assert res["collectives_probes"] == res["collectives"]


@pytest.mark.parametrize("policy", ["tp", "fsdp"])
def test_probes_past_one_ce_chunk(policy, small_shapes, monkeypatch):
    """At a sequence of two CE chunks of 512 (the second one short), the
    1- and 2-unit probes, which take the CE in the whole cell's chunks,
    extrapolate to the 3-unit trace's cost and collectives exactly (the
    policies whose logits are split over the model axis: one CE chunk
    moved their FLOPs on the card)."""
    monkeypatch.setenv("REPRO_TORCH_MESH_OVERRIDE", "4,4")
    small_shapes(units=3, policy=policy)
    monkeypatch.setitem(SHAPES, "train_4k", ShapeConfig("train_4k", 1024, 16, "train"))
    res = DR.run_cell(POLICY_ARCHS[policy], "train_4k", "single", device="cpu",
                      mesh_device_type="cpu")
    assert res["status"] == "ok"
    assert res["cost_probes"] == res["cost"] == res["cost_raw_scanned"]
    assert res["collectives_probes"] == res["collectives"]


def test_mesh_device_is_asked_for():
    """The records' ranks are CUDA ranks: a CPU mesh, whose collectives
    differ, only when asked for; a CUDA mesh without CUDA raises."""
    assert DR.mesh_device("cpu") == "cpu"
    with pytest.raises(ValueError):
        DR.mesh_device("meta")
    if torch.cuda.is_available():
        assert DR.mesh_device() == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            DR.run_cell("gemma2-2b", "train_4k", "single")


def test_dp_only_flops_split_over_ranks(small_shapes, monkeypatch):
    small_shapes(policy="dp_only")
    monkeypatch.setenv("REPRO_TORCH_MESH_OVERRIDE", "4,4")
    per_rank = DR.run_cell("gemma3-1b", "train_4k", "single", cost_probes=False, device="cpu",
                           mesh_device_type="cpu")
    monkeypatch.setenv("REPRO_TORCH_MESH_OVERRIDE", "1,1")
    one = DR.run_cell("gemma3-1b", "train_4k", "single", cost_probes=False, device="cpu",
                      mesh_device_type="cpu")
    assert per_rank["cost"]["flops"] * 16 == one["cost"]["flops"]
    assert one["collectives"]["total_bytes"] == 0


@pytest.mark.parametrize("arch,shape", [("deepseek-moe-16b", "prefill_32k"),
                                        ("gemma2-2b", "decode_32k"),
                                        ("gemma2-2b", "long_500k"),
                                        ("musicgen-large", "long_500k")])
def test_serving_cells(arch, shape, small_shapes, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_MESH_OVERRIDE", "2,4,4")
    small_shapes()
    res = DR.run_cell(arch, shape, "multi", cost_probes=False, device="cpu",
                      mesh_device_type="cpu")
    ok, _ = SPEC.cell_is_applicable(arch, shape)
    assert res["status"] == ("ok" if ok else "skipped")
    assert (arch, shape, ok) != ("musicgen-large", "long_500k", True)
    if ok:
        assert res["memory"]["output_size_bytes"] > 0 and res["hlo_ops"] > 0
