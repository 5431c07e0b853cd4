"""One rank of tests/test_torch_distributed.py's gloo runs.

    python _torch_dist_worker.py RANK WORLD INIT_FILE DATA.npz OUT_DIR

Joins a gloo group through `file://INIT_FILE`, loads the shared inputs,
runs every check of `repro_torch.core.distributed` against the port's
single-process results, and writes `OUT_DIR/rank<R>.json` (check name ->
true, or the error) and, from rank 0, `OUT_DIR/results.npz` (the
distributed searches' ids and dists, for the comparison with the JAX
search). Imports torch and repro_torch only.
"""

from __future__ import annotations

import json
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import (
    Draws,
    DynamicConfig,
    DynamicIndex,
    GRNNDConfig,
    HostTier,
    Pool,
    RecordedDraws,
    Requests,
    build_graph,
    encode,
    encode_labels,
    insert_requests,
    optimize,
    search,
)
from repro_torch.core import corpus_shard as CS
from repro_torch.core import distributed as D

K, EF = 10, 32
CFG = GRNNDConfig(s=8, r=16, t1=2, t2=2, pairs_per_vertex=16)


def _same(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


def checks(data, world: int, keep: dict):
    """(name, thunk) of every check; a thunk returns True when it holds and
    may leave arrays in `keep`."""
    x = torch.from_numpy(data["x"])
    q, q13 = torch.from_numpy(data["q"]), torch.from_numpy(data["q13"])
    ids = torch.from_numpy(data["ids"])
    labels = encode_labels(data["vlabels"], 20)
    fw = torch.from_numpy(data["fwords"])
    valid = torch.from_numpy(data["valid"])
    x8 = encode(x, "int8")
    cpu = dict(device="cpu")

    def query_sharded(name, queries, x_, **kw):
        def run():
            got = D.distributed_search(x_, ids, queries, k=K, ef=EF, **cpu, **kw)
            keep[name] = got
            return _same(got, search(x_, ids, queries, k=K, ef=EF, **cpu, **kw))

        return name, run

    def optimized():
        opt = optimize(x8, ids, order="bfs", rescore=x, valid=valid, labels=labels, **cpu)
        got = opt.distributed_search(q, k=K, ef=EF, filter=fw)
        keep["search-optimized"] = got
        return _same(got, opt.search(q, k=K, ef=EF, filter=fw))

    def corpus(name, x_, shard_kw, **kw):
        def run():
            idx = CS.shard(x_, ids, world, **cpu, **shard_kw)
            got = CS.sharded_search(idx, q, k=K, ef=EF, group=dist.group.WORLD, **kw)
            return _same(got, CS.sharded_search(idx, q, k=K, ef=EF, **kw))

        return name, run

    def apply_requests():
        g = torch.Generator().manual_seed(5)
        n, r = ids.shape
        pool = Pool(ids.clone(), torch.from_numpy(data["dists"]))
        m = 3 * n
        req = Requests(
            dst=torch.randint(-1, n, (m,), generator=g, dtype=torch.int32),
            src=torch.randint(0, n, (m,), generator=g, dtype=torch.int32),
            dist=torch.rand((m,), generator=g),
        )
        got = D.sharded_apply_requests(pool, req, cap=r)
        return _same(got, insert_requests(pool, req, cap=r))

    def dynamic_insert():
        n = x.shape[0]
        base = n - 56
        pool = build_graph(x[:base], CFG, draws=Draws(2, "cpu"), **cpu)
        kw = dict(draws=Draws(3, "cpu"), **cpu)
        dc = DynamicConfig(refine_rounds=1, compact_threshold=0.9)
        plain = DynamicIndex(x[:base], pool, dc, **kw)
        routed = DynamicIndex(x[:base], pool, dc, group=dist.group.WORLD, **kw)
        ok = True
        for lo in range(base, n, 28):  # two batches
            ok &= torch.equal(plain.insert(x[lo : lo + 28]), routed.insert(x[lo : lo + 28]))
            ok &= _same(plain.pool, routed.pool)
        return bool(ok) and _same(plain.search(q, k=K, ef=EF), routed.search(q, k=K, ef=EF))

    def builds():
        draws = Draws(7, "cpu")
        stats = {}
        a = D.sharded_build_graph(x, CFG, draws=draws, **cpu)
        b = D.sharded_build_graph(x, CFG, comm="a2a", draws=draws, stats=stats, **cpu)
        keep["a2a_dropped"] = stats["a2a_dropped"]
        return stats["a2a_dropped"] == 0 and _same(a, b)

    def build_vs_single():
        draws = Draws(7, "cpu")
        got = D.sharded_build_graph(x, CFG, draws=draws, **cpu)
        n, r, p = x.shape[0], CFG.r, CFG.pairs_per_vertex
        n_loc = n // world
        pairs = {}
        for t1 in range(CFG.t1):
            for t2 in range(CFG.t2):
                parts = [draws.shard_slot_pairs(t1, t2, s, n_loc, r, p) for s in range(world)]
                pairs[(t1, t2, None)] = tuple(torch.cat(z).numpy() for z in zip(*parts))
        rec = RecordedDraws(init=draws.init_ids(n, CFG.s).numpy(), pairs=pairs)
        return _same(got, build_graph(x, CFG, draws=rec, **cpu))

    def build_sorted():
        cfg = CFG._replace(order="ascending")
        got = D.sharded_build_graph(x, cfg, draws=Draws(8, "cpu"), comm="a2a", **cpu)
        return _same(got, build_graph(x, cfg, draws=Draws(8, "cpu"), **cpu))

    return [
        query_sharded("search-unfiltered", q, x),
        query_sharded("search-filtered", q, x, labels=labels, filter=fw),
        query_sharded("search-hashed", q, x, visited="hashed", visited_cap=64),
        query_sharded("search-int8-rescore", q, x8, rescore=x, valid=valid),
        query_sharded("search-host", q, x8, rescore=HostTier(x), labels=labels, filter=fw),
        ("search-optimized", optimized),
        query_sharded("search-odd-q", q13, x, visited="hashed"),
        corpus("corpus-fp32", x, {}),
        corpus("corpus-filtered-hashed", x, dict(labels=labels), filter=fw, visited="hashed",
               visited_cap=64),
        corpus("corpus-int8-valid", x8, dict(rescore=x, valid=valid)),
        corpus("corpus-host", x8, dict(rescore=x, labels=labels, tier="host"), filter=fw),
        ("apply-requests", apply_requests),
        ("dynamic-insert", dynamic_insert),
        ("build-allgather-a2a", builds),
        ("build-vs-single", build_vs_single),
        ("build-sorted", build_sorted),
    ]


def main(rank: int, world: int, init_file: str, data_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    data = dict(np.load(data_path))
    keep, report = {}, {}
    for name, run in checks(data, world, keep):
        try:
            report[name] = bool(run())
        except Exception:  # recorded: the test names the check that raised
            report[name] = traceback.format_exc()
    out = Path(out_dir)
    (out / f"rank{rank}.json").write_text(json.dumps(report))
    if rank == 0:
        arrays = {}
        for name, res in keep.items():
            if hasattr(res, "ids"):
                arrays[f"{name}/ids"] = res.ids.numpy()
                arrays[f"{name}/dists"] = res.dists.numpy()
        np.savez(out / "results.npz", **arrays)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
