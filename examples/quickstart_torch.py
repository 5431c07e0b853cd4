"""Quickstart on the PyTorch port: build a GRNND graph, search it, measure recall.

    PYTHONPATH=src python examples/quickstart_torch.py                # on a card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # plain PyTorch

The same steps as `examples/quickstart.py`, run by `repro_torch`: on a CUDA
device the build and the search launch the hand-written kernels, on the CPU
their plain versions.
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
    ap.add_argument("--n", type=int, default=10_000)
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    # 1. a clustered vector dataset (SIFT-like, reduced scale)
    gen = torch.Generator(dev).manual_seed(0)
    x = synthetic.make_preset(gen, "sift-like", args.n)
    queries = synthetic.queries_from(gen, x, 500)
    print(f"dataset: {x.shape[0]} vectors, d={x.shape[1]}, on {dev}")

    # 2. build the ANN graph with GRNND (disordered propagation, double-
    #    buffered fixed pools, reverse-edge sampling: paper Alg. 3)
    cfg = GRNNDConfig(s=12, r=24, t1=3, t2=4, rho=0.6, pairs_per_vertex=24)
    _sync(dev)
    t0 = time.perf_counter()
    pool = build_graph(x, cfg, draws=Draws(2, dev), device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    degree = float(pool.degree().float().mean())
    print(f"built graph in {build_s:.2f}s (mean degree {degree:.1f})")

    # 3. search and evaluate against brute force
    gt = brute_force_knn(x, queries, 10, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    res = search(x, pool.ids, queries, k=10, ef=48, device=dev)
    _sync(dev)
    dt = time.perf_counter() - t0
    rec = recall_at_k(res.ids, gt)
    print(
        f"recall@10 = {rec:.3f}   qps = {queries.shape[0] / dt:.0f}   "
        f"mean dist-evals/query = {float(res.n_expanded.float().mean()):.0f}"
    )
    return {"recall_at_10": rec, "build_s": build_s, "degree": degree}


if __name__ == "__main__":
    main()
