"""Build a GRNND index over a seeded synthetic dataset, search it, and save it.

    PYTHONPATH=src python -m repro_torch.launch.build_index --dataset sift1m \
        --out /path/to/sift1m.idx.npz [--device cuda] [--ef 64] [--seed 0]

The dataset is the `*-like` preset of the config's family at the config's
full n and d. The build uses the config's GRNNDConfig; the config's held-out
queries are searched with the hashed visited set. It prints build seconds,
search QPS and recall@10, and saves ids / dists / x.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.grnnd_paper import DATASETS
from repro_torch.core import brute_force_knn, build_graph, recall_at_k, search
from repro_torch.core.draws import Draws
from repro_torch.data import synthetic

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
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    ds = DATASETS[args.dataset]
    gen = torch.Generator(dev).manual_seed(args.seed)
    x = synthetic.make_preset(gen, _PRESETS[ds.name[:4]], ds.n)
    queries = synthetic.queries_from(gen, x, ds.n_queries)

    _sync(dev)
    t0 = time.perf_counter()
    pool = build_graph(x, ds.build, draws=Draws(args.seed + 1, dev), device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0

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
        f"built {ds.name} (n={ds.n}, d={ds.d}) on {dev} in {build_s:.2f}s; "
        f"ef={args.ef}: {stats['qps']:.0f} QPS, recall@{ds.k}={stats['recall_at_10']:.4f} "
        f"-> {args.out}"
    )
    return stats


if __name__ == "__main__":
    main()
