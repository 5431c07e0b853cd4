"""Build a GRNND index over a seeded synthetic dataset, search it, and save it.

    PYTHONPATH=src python -m repro_torch.launch.build_index --dataset sift1m \
        --out /path/to/sift1m.idx.npz [--device cuda] [--ef 64] [--seed 0]
    torchrun --nproc-per-node 2 -m repro_torch.launch.build_index --dataset sift-small \
        --out /path/to/sift-small.idx.npz --sharded [--device cpu]

The dataset is the `*-like` preset of the config's family at the config's
full n and d. The build uses the config's GRNNDConfig; the config's held-out
queries are searched with the hashed visited set. It prints build seconds,
search QPS and recall@10, and saves ids / dists / x.

`--sharded` builds over the ranks of the default process group
(`core.distributed.sharded_build_graph`, the pool split by vertices; n must
split evenly over the ranks): under `torchrun` the CLI joins its group
(NCCL on cards, one rank a card; gloo on the CPU), outside it the group is
this process alone. Rank r draws its slot pairs from the same seed's
`Draws`, so the graph is not the unsharded build's. Only rank 0 searches,
prints and saves.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.grnnd_paper import DATASETS
from repro_torch.core import brute_force_knn, build_graph, recall_at_k, search
from repro_torch.core.distributed import sharded_build_graph
from repro_torch.core.draws import Draws
from repro_torch.data import synthetic
from repro_torch.launch import _group

_PRESETS = {"sift": "sift-like", "deep": "deep-like", "gist": "gist-like"}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="sift1m", choices=sorted(DATASETS))
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ef", type=int, default=64)
    ap.add_argument("--sharded", action="store_true",
                    help="build over the ranks of the default process group")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    made = False
    if args.sharded:
        dev, made = _group.join(dev)
    try:
        return _build(args, dev)
    finally:
        if made:
            torch.distributed.destroy_process_group()


def _build(args, dev: torch.device) -> dict:
    ds = DATASETS[args.dataset]
    gen = torch.Generator(dev).manual_seed(args.seed)
    x = synthetic.make_preset(gen, _PRESETS[ds.name[:4]], ds.n)
    queries = synthetic.queries_from(gen, x, ds.n_queries)

    _sync(dev)
    t0 = time.perf_counter()
    draws = Draws(args.seed + 1, dev)
    if args.sharded:
        pool = sharded_build_graph(x, ds.build, draws=draws, device=dev)
    else:
        pool = build_graph(x, ds.build, draws=draws, device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    if _group.rank() != 0:
        return {"build_s": build_s}

    truth = brute_force_knn(x, queries, ds.k, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    res = search(x, pool.ids, queries, k=ds.k, ef=args.ef, visited="hashed", device=dev)
    _sync(dev)
    search_s = time.perf_counter() - t0
    stats = {
        "dataset": ds.name,
        "n": ds.n,
        "d": ds.d,
        "device": str(dev),
        "sharded": args.sharded,
        "ranks": _group.world_size() if args.sharded else 1,
        "build_s": build_s,
        "qps": ds.n_queries / search_s,
        "recall_at_10": recall_at_k(res.ids, truth),
    }
    np.savez(
        args.out,
        ids=pool.ids.cpu().numpy(),
        dists=pool.dists.cpu().numpy(),
        x=x.cpu().numpy(),
    )
    print(
        f"built {ds.name} (n={ds.n}, d={ds.d}) on {dev} over {stats['ranks']} rank(s) "
        f"in {build_s:.2f}s; "
        f"ef={args.ef}: {stats['qps']:.0f} QPS, recall@{ds.k}={stats['recall_at_10']:.4f} "
        f"-> {args.out}"
    )
    return stats


if __name__ == "__main__":
    main()
