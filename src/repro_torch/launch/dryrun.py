"""Production-mesh dry-run: trace every (arch x shape) cell on the
production meshes and record one rank's memory, cost and collectives.

A port of the JAX package's `launch/dryrun.py`. Where the reference lowers
and compiles each cell with `jax.jit` over 256 or 512 forced host devices,
the port traces it once in one process that stands for rank 0 of a fake
process group of 256 (16 x 16) or 512 (2 x 16 x 16) ranks
(`launch/mesh.join_fake_group`): the parameters, optimizer state, batches
and caches are DTensors over `meta` tensors, placed by
`distributed/sharding`'s specs (`launch/specs.py`), so no parameter is
allocated, and the collectives DTensor issues return at once. `RankCounter`,
a dispatch mode under DTensor, sees the local ops rank 0 runs: their FLOPs
(PyTorch's `FlopCounterMode` formulas on the local shapes), bytes, the
collectives' result bytes and the bytes alive at once. The GRNND cells
(`grnnd-ann`) run rank 0's build round for real, on the card unless asked
otherwise.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --include-grnnd --mesh both --out results/dryrun_torch
Each cell writes its JSON record to --out; a cell whose record there is
`ok` or `skipped`, on the same mesh device, is not traced again. The ranks
are CUDA ranks, as on the card; `--mesh-device cpu` traces CPU ranks where
there is no CUDA, whose collectives differ (`mesh_device`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import pathlib
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor import _sharding_prop
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import SHAPES, n_pattern_units
from repro_torch.distributed import sharding as SH
from repro_torch.launch import specs as SPEC
from repro_torch.launch.mesh import join_fake_group, make_production_mesh, merge_pod

_SHARDING_PROP_FILE = _sharding_prop.__file__

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# the c10d and functional-collective ops (those `CommDebugMode` counts) under
# the reference's five HLO names; an op a PyTorch build lacks is left out
_COLLECTIVE_OPS = {
    "all-gather": ("_c10d_functional.all_gather_into_tensor",
                   "_c10d_functional.all_gather_into_tensor_out",
                   "_c10d_functional.all_gather_into_tensor_coalesced",
                   "_c10d_functional_autograd.all_gather_into_tensor",
                   "c10d.allgather_", "c10d._allgather_base_", "c10d.allgather_coalesced_",
                   "c10d.allgather_into_tensor_coalesced_"),
    "all-reduce": ("_c10d_functional.all_reduce", "_c10d_functional.all_reduce_",
                   "_c10d_functional.all_reduce_coalesced",
                   "_c10d_functional.all_reduce_coalesced_",
                   "c10d.allreduce_", "c10d.allreduce_coalesced_"),
    "reduce-scatter": ("_c10d_functional.reduce_scatter_tensor",
                       "_c10d_functional.reduce_scatter_tensor_out",
                       "_c10d_functional.reduce_scatter_tensor_coalesced",
                       "_c10d_functional_autograd.reduce_scatter_tensor",
                       "c10d.reduce_scatter_", "c10d._reduce_scatter_base_",
                       "c10d.reduce_scatter_tensor_coalesced_"),
    "all-to-all": ("_c10d_functional.all_to_all_single",
                   "_c10d_functional_autograd.all_to_all_single",
                   "_dtensor.shard_dim_alltoall", "c10d.alltoall_", "c10d.alltoall_base_"),
    "collective-permute": ("_c10d_functional.irecv", "c10d.recv_"),
}

# element-wise ops that evaluate a transcendental function once an output
# element (XLA's `transcendentals`)
_TRANSCENDENTAL = ("exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "sigmoid",
                   "silu", "gelu", "rsqrt", "sqrt", "sin", "cos", "erf", "pow",
                   "_softmax", "_log_softmax", "logsumexp")

# metadata queries: let a subclass answer them (as `FlopCounterMode` does)
_QUERIES = ("sym_is_contiguous.default", "is_contiguous.default", "is_contiguous.memory_format",
            "is_strides_like_format.default", "is_non_overlapping_and_dense.default",
            "size.default", "sym_size.default", "stride.default", "sym_stride.default",
            "storage_offset.default", "sym_storage_offset.default", "numel.default",
            "sym_numel.default", "dim.default")


def _op(qualname: str):
    ns, name = qualname.split(".", 1)
    op = getattr(torch.ops, ns)
    for part in name.split("."):
        if not hasattr(op, part):
            return None
        op = getattr(op, part)
    return op


def _collective_names() -> dict:
    out = {}
    for name, quals in _COLLECTIVE_OPS.items():
        for q in quals:
            op = _op(q)
            if op is not None:
                out[op] = name
    return out


def _tensors(x) -> list[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _is_view(func) -> bool:
    """Whether every result of `func` aliases an input without writing it
    (a view): such an op reads and writes no bytes."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagation is running: it runs ops on
    fake or `meta` tensors of global shapes (the first time it meets an op
    and its input placements, then from a cache) to find the output
    placements."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename == _SHARDING_PROP_FILE:
            return True
        f = f.f_back
    return False


class RankCounter(TorchDispatchMode):
    """Counts what one rank runs, under DTensor.

    An op on DTensors is handed on (`NotImplemented`, as `CommDebugMode`
    does), so DTensor runs it and the local ops it issues (the computation
    on each local block, and the collectives of its redistributions) come
    back here on plain tensors. For each local op:

      * `flops`: `torch.utils.flop_counter`'s formula, decomposed first
        where `FlopCounterMode` decomposes, so on plain tensors the count
        is `FlopCounterMode`'s;
      * `bytes_accessed`: the bytes of its tensor inputs and outputs, as
        eager PyTorch runs it (no fusion; views and metadata ops move none);
      * `transcendentals`: the output elements of exp / log / tanh / ...;
      * `collectives`: the result bytes and count of each collective, under
        the reference's five HLO names;
      * `ops`: the local ops run;
      * `peak_bytes`: the most bytes of storage alive at once among the
        storages the ops made (outputs, saved activations, collective
        buffers); storages that existed before are not counted.

    Counted are the ops on `device`'s tensors (any device if None) outside
    DTensor's sharding propagation: the ops that propagation runs at global
    shapes, and the ones its redistribution planning runs on small CPU
    tensors, are not the rank's work (and run only while their caches are
    cold, which would make a count depend on what was traced before).
    """

    def __init__(self, device: torch.device | None = None):
        super().__init__()
        self.device = device
        from torch.utils.flop_counter import FlopCounterMode

        self._flops = FlopCounterMode(display=False)
        self._coll = _collective_names()
        self._queries = {_op("aten." + q) for q in _QUERIES} | {torch.ops.prim.layout.default}
        self._trans = {p for p in (_op("aten." + n) for n in _TRANSCENDENTAL) if p is not None}
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.ops = 0
        self.collectives = {c: 0 for c in COLLECTIVES}
        self.n_collectives = {c: 0 for c in COLLECTIVES}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}

    @property
    def flops(self) -> int:
        return self._flops.get_total_flops()

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor, before: set) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in before or key in self._live:
            return
        self._live[key] = st.nbytes()
        self.live_bytes += st.nbytes()
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        import weakref

        weakref.finalize(st, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if func in self._queries or any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ins = _tensors((args, kwargs))
        if _in_sharding_propagation():
            return func(*args, **kwargs)
        if func._overloadpacket not in self._flops.flop_registry \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        before = {t.untyped_storage()._cdata for t in ins}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if self.device is not None and all(t.device != self.device for t in (*ins, *outs)):
            return out
        self._flops._count_flops(func._overloadpacket, out, args, kwargs)
        self.ops += 1
        name = self._coll.get(func._overloadpacket)
        if name is not None:
            res = outs or _tensors(args[0])
            self.collectives[name] += sum(t.nbytes for t in res)
            self.n_collectives[name] += 1
        if not _is_view(func):
            self.bytes_accessed += sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)
        if func._overloadpacket in self._trans:
            self.transcendentals += sum(t.numel() for t in outs)
        for t in outs:
            self._track(t, before)
        return out

    def collective_record(self) -> dict:
        return {**self.collectives, **{f"n_{k}": v for k, v in self.n_collectives.items()},
                "total_bytes": sum(self.collectives.values())}


def trace_stats(fn, args) -> dict:
    """Run `fn(*args)` once under a `RankCounter` of the arguments' device:
    the reference's `_compile_stats` record, one rank's. `argument_size_bytes` is the
    arguments' local bytes, `output_size_bytes` the outputs' (a storage the
    outputs share with the arguments counts there), `temp_size_bytes` the
    peak of the bytes the run allocated; `trace_s` the run's seconds."""
    first = _tensors(args)[0]
    counter = RankCounter((first.to_local() if isinstance(first, DTensor) else first).device)
    t0 = time.perf_counter()
    with counter:
        out = fn(*args)
    if any(t.is_cuda for t in _tensors(out) if not isinstance(t, DTensor)):
        torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    arg_bytes = SH.local_bytes(args)
    return {
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_size_bytes": arg_bytes,
            "output_size_bytes": SH.local_bytes((args, out)) - arg_bytes,
            "temp_size_bytes": counter.peak_bytes,
        },
        "cost": {
            "flops": float(counter.flops),
            "bytes_accessed": float(counter.bytes_accessed),
            "transcendentals": float(counter.transcendentals),
        },
        "collectives": counter.collective_record(),
        "hlo_ops": counter.ops,
    }


def _extrapolate(p1: dict, p2: dict, units: int) -> dict:
    """cost(full) = cost(1 unit) + (units - 1) * [cost(2) - cost(1)]."""
    def lerp(a, b):
        return a + (units - 1) * (b - a)

    out = {"cost": {}, "collectives": {}}
    for k in p1["cost"]:
        out["cost"][k] = lerp(p1["cost"][k], p2["cost"][k])
    for k in p1["collectives"]:
        out["collectives"][k] = lerp(p1["collectives"][k], p2["collectives"][k])
    return out


def mesh_world(mesh_kind: str) -> int:
    """The ranks of `mesh_kind`'s production mesh: 256 ("single"), 512
    ("multi"), or those of REPRO_TORCH_MESH_OVERRIDE."""
    override = os.environ.get("REPRO_TORCH_MESH_OVERRIDE")
    if override:
        return math.prod(int(v) for v in override.split(","))
    return 512 if mesh_kind == "multi" else 256


def mesh_device(requested: str = "cuda") -> str:
    """The device type of the traced ranks, `requested` ("cuda" or "cpu"),
    checked. DTensor picks collectives by it, and propagates shardings on
    fake tensors of that type: on a CPU mesh it moves a shard from one dim
    to another by all-gather and a local chunk where a CUDA mesh takes one
    all-to-all, so a CPU mesh's record differs from the card's. The port's
    records are the CUDA mesh's; a CPU mesh is taken only when asked for
    (the tests), and a CUDA mesh without CUDA raises."""
    if requested not in ("cuda", "cpu"):
        raise ValueError(f"mesh device {requested!r}: 'cuda' or 'cpu'")
    if requested == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs CUDA; a CPU mesh (mesh_device='cpu', "
                           "--mesh-device cpu) gives other collectives than the card's")
    return requested


@contextlib.contextmanager
def fake_group(world: int):
    """A fake default group of `world` ranks, this process rank 0, for the
    body; an existing default group is used as it is (and kept)."""
    if dist.is_initialized():
        yield
        return
    join_fake_group(world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape: str, mesh_kind: str, cost_probes: bool = True,
             remat_policy: str = "full", device: str = "cuda",
             mesh_device_type: str = "cuda") -> dict:
    """One cell's record on `mesh_kind`'s production mesh ("single" or
    "multi"): status ("ok" or "skipped", with a reason), the mesh, and
    `trace_stats`' figures of the whole-depth trace, its cost also as
    `cost_raw_scanned`; with `cost_probes`, the 1- and 2-unit probes'
    cost and collectives extrapolated over the arch's units as
    `cost_probes` and `collectives_probes` (the whole trace is exact: the
    port has no scanned body for XLA's count to miss). The LM cells trace
    on `meta`, a two-pod mesh with its pod and data dimensions merged
    (`traced_mesh`, `launch/mesh.merge_pod`), the ranks of
    `mesh_device_type` (`mesh_device`); `device` is where the GRNND cells
    run. A cell that cannot be traced raises. Joins a fake group of the
    mesh's ranks unless a default group exists."""
    mesh_dev = mesh_device(mesh_device_type)
    with fake_group(mesh_world(mesh_kind)):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi", device=mesh_dev)
        traced = merge_pod(mesh)
        result: dict = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                        "mesh_shape": SH.axis_sizes(mesh), "traced_mesh": SH.axis_sizes(traced),
                        "mesh_device": mesh.device_type}
        ok, reason = SPEC.cell_is_applicable(arch, shape)
        if not ok:
            result["status"] = "skipped"
            result["reason"] = reason
            return result

        fn, args = SPEC.make_cell(arch, shape, traced, remat_policy=remat_policy, device=device)
        full = trace_stats(fn, args)
        del fn, args
        result.update({"status": "ok", **full})
        result["cost_raw_scanned"] = full["cost"]

        if cost_probes and arch != "grnnd-ann" and n_pattern_units(get_arch(arch)) >= 2:
            ex, secs = probe_cost(arch, shape, traced, remat_policy)
            result["cost_probes"] = ex["cost"]
            result["collectives_probes"] = ex["collectives"]
            result["probe_compile_s"] = secs
        return result


def probe_cost(arch: str, shape, mesh, remat_policy: str = "full") -> tuple[dict, list]:
    """The cost and collectives of an LM cell on `mesh` from its 1- and
    2-unit probes, extrapolated over the arch's pattern units, and the two
    probes' trace seconds: the whole-depth trace's figures at a fraction
    of its time, as counts linear in the units are."""
    probes = []
    for k in (1, 2):
        fk, ak = SPEC.make_cell(arch, shape, mesh, cost_probe=k, remat_policy=remat_policy)
        probes.append(trace_stats(fk, ak))
        del fk, ak
    ex = _extrapolate(probes[0], probes[1], n_pattern_units(get_arch(arch)))
    return ex, [p["trace_s"] for p in probes]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-grnnd", action="store_true")
    ap.add_argument("--remat-policy", type=str, default="full")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the GRNND cells run (the LM cells trace on meta)")
    ap.add_argument("--mesh-device", choices=["cuda", "cpu"], default="cuda",
                    help="the traced ranks' device type; a cpu mesh's collectives differ "
                         "from the card's")
    ap.add_argument("--out", type=str, default="results/dryrun_torch")
    args = ap.parse_args()

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.all:
        cells = [(a, s) for a in list_archs() for s in SHAPES]
        if args.include_grnnd:
            cells += [("grnnd-ann", s) for s in SPEC.GRNND_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    mesh_device(args.mesh_device)

    t_start = time.perf_counter()
    n_ok = n_skip = n_fail = 0
    for mk in meshes:
        # one fake group a mesh kind, for all its cells
        with fake_group(mesh_world(mk)):
            for arch, shape in cells:
                tag = f"{arch}__{shape}__{mk}"
                fpath = outdir / f"{tag}.json"
                if fpath.exists():
                    prev = json.loads(fpath.read_text())
                    if prev.get("status") in ("ok", "skipped") \
                            and prev.get("mesh_device") == args.mesh_device:
                        print(f"[cached] {tag}: {prev['status']}")
                        n_ok += prev["status"] == "ok"
                        n_skip += prev["status"] == "skipped"
                        continue
                try:
                    res = run_cell(arch, shape, mk, remat_policy=args.remat_policy,
                                   device=args.device, mesh_device_type=args.mesh_device)
                except Exception as e:  # record the failure, keep sweeping
                    res = {"arch": arch, "shape": shape, "mesh": mk,
                           "status": "failed", "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                fpath.write_text(json.dumps(res, indent=2))
                st = res["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_fail += st == "failed"
                extra = ""
                if st == "ok":
                    gb = res["memory"]["argument_size_bytes"] / 2**30
                    extra = (f" trace={res['trace_s']}s arg={gb:.2f}GiB "
                             f"coll={res['collectives']['total_bytes'] / 2**30:.2f}GiB")
                elif st == "failed":
                    extra = " " + res["error"][:160]
                print(f"[{st}] {tag}{extra}", flush=True)

    print(f"\nDONE ok={n_ok} skipped={n_skip} failed={n_fail} "
          f"wall={time.perf_counter() - t_start:.1f}s")


if __name__ == "__main__":
    main()
