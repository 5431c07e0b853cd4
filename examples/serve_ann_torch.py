"""End to end on the PyTorch port: build a GRNND index, then serve
batched ANN queries with a latency / recall report.

    PYTHONPATH=src python examples/serve_ann_torch.py [--n 30000] [--d 96]   # on a card
    PYTHONPATH=src python examples/serve_ann_torch.py --device cpu --n 3000  # plain PyTorch

The same steps as `examples/serve_ann.py`, run by `repro_torch`: index
construction (the paper's contribution) feeding online search. On a CUDA
device both launch the hand-written kernels, on the CPU their plain
versions.
"""

import argparse
import time

import torch

from repro_torch import device as _device
from repro_torch.core import Draws, GRNNDConfig, brute_force_knn, build_graph, recall_at_k
from repro_torch.core.search import search
from repro_torch.data import synthetic


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=30_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--ef", type=int, default=48)
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    gen = torch.Generator(dev).manual_seed(0)
    x = synthetic.vector_dataset(gen, args.n, args.d, n_clusters=128)

    # ---- offline stage: index construction (the paper's bottleneck) ----
    cfg = GRNNDConfig(s=16, r=32, t1=3, t2=4, rho=0.6, pairs_per_vertex=32)
    _sync(dev)
    t0 = time.perf_counter()
    pool = build_graph(x, cfg, draws=Draws(1, dev), device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    degree = float(pool.degree().float().mean())
    print(f"[build] n={args.n} d={args.d} on {dev}  {build_s:.2f}s  mean_degree={degree:.1f}")

    # ---- online stage: batched query serving ----
    lat, recs = [], []
    for b in range(args.batches):
        q = synthetic.queries_from(torch.Generator(dev).manual_seed(100 + b), x, args.batch_size)
        _sync(dev)
        t0 = time.perf_counter()
        res = search(x, pool.ids, q, k=10, ef=args.ef, device=dev)
        _sync(dev)
        dt = time.perf_counter() - t0
        if b == 0:
            continue  # the first batch is the warm-up; measure steady state
        lat.append(dt)
        recs.append(recall_at_k(res.ids, brute_force_knn(x, q, 10, device=dev)))

    qps = args.batch_size / (sum(lat) / len(lat))
    p50 = sorted(lat)[len(lat) // 2] * 1e3
    rec = sum(recs) / len(recs)
    print(f"[serve] batches={len(lat)} batch={args.batch_size} ef={args.ef}")
    print(f"[serve] p50_latency={p50:.1f}ms  qps={qps:.0f}  recall@10={rec:.3f}")
    return {"build_s": build_s, "degree": degree, "qps": qps, "p50_ms": p50, "recall_at_10": rec}


if __name__ == "__main__":
    main()
