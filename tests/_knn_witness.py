"""The JAX reference's GRNND build and search on kNN-LM states from the card.

`python3 chip_smoke.py --knn-states PATH` saves phase 4i's witness subset:
2^14 stored keys and 256 held-out states of gemma3-1b at full width (random
weights, bf16 hidden states, kept exactly), with the vertex sample, the
random rows and the card's brute-force truth. This script builds and
searches that subset on the CPU with the JAX reference (`ref` kernels), and
with the port's plain versions twice: on the draws of the seeds phase 4i
uses, and on the reference's own draws (`RecordedDraws`, as
`tests/test_torch_grnnd.py` replays them), with `DEFAULT_BUILD_CFG` and
ef 32 as there. It prints, one line each, recall@10 and the distance
excess of the search and of the pools. Phase 4i prints the card's lines
for the same states; side by side they tell whether the low recall of a
random model's states is the data's or the port's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_knn_witness.py chiprun_out/knn_states.npz
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import grnnd as jgrnnd
from repro.core.search import search as jsearch
from repro.kernels import ops as jops
from repro.retrieval.knn_lm import DEFAULT_BUILD_CFG as JCFG
from repro_torch.core import (
    Draws,
    brute_force_knn,
    build_graph,
    distance_excess,
    pool_excess,
    recall_at_k,
    search,
)
from repro_torch.core.draws import RecordedDraws
from repro_torch.retrieval.knn_lm import DEFAULT_BUILD_CFG

EF, SEEDS = 32, (0, 1, 2)


def _f32(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits).view(torch.bfloat16).float()


def _reference_draws(key, n: int, cfg) -> RecordedDraws:
    """The draws `repro.core.grnnd.build_graph(key, x, cfg)` makes with an
    unchunked round, recorded for the port's build."""
    k_init, k_rounds = jax.random.split(key)
    init = jax.random.randint(k_init, (n, cfg.s), 0, n - 1, jnp.int32)
    pairs = {}
    for t1 in range(cfg.t1):
        for t2 in range(cfg.t2):
            k = jax.random.fold_in(jax.random.fold_in(k_rounds, t1), t2)
            si, sj = jgrnnd._sample_slot_pairs(k, n, cfg.r, cfg.pairs_per_vertex)
            pairs[(t1, t2, None)] = (np.asarray(si), np.asarray(sj))
    return RecordedDraws(np.asarray(init), pairs)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("states", help="the npz that chip_smoke.py --knn-states wrote")
    args = ap.parse_args()
    z = np.load(args.states)
    x, q = _f32(z["x"]), _f32(z["q"])
    verts, rq, rv = (torch.from_numpy(z[k]).long() for k in ("verts", "rq", "rv"))
    truth, vknn = torch.from_numpy(z["truth"]), torch.from_numpy(z["vknn"])
    # the card's truth, checked here (sets; ties may order differently)
    agree = recall_at_k(brute_force_knn(x, q, 10, device="cpu"), truth)
    print(json.dumps({"n": x.shape[0], "d": x.shape[1], "queries": q.shape[0],
                      "truth_agrees_with_the_card": agree}), flush=True)
    jx, jq = jnp.asarray(x.numpy()), jnp.asarray(q.numpy())
    for seed in SEEDS:
        t0 = time.perf_counter()
        with jops.backend("ref"):
            jpool = jgrnnd.build_graph(jax.random.PRNGKey(seed), jx, JCFG)
            jres = jsearch(jx, jpool.ids, jq, k=10, ef=EF)
        jid = torch.from_numpy(np.array(jres.ids))
        pid = torch.from_numpy(np.array(jpool.ids))
        t1 = time.perf_counter()
        pool = build_graph(x, DEFAULT_BUILD_CFG, draws=Draws(seed, "cpu"), device="cpu")
        res = search(x, pool.ids, q, k=10, ef=EF, device="cpu")
        t2 = time.perf_counter()
        draws = _reference_draws(jax.random.PRNGKey(seed), x.shape[0], JCFG)
        rpool = build_graph(x, DEFAULT_BUILD_CFG, draws=draws, device="cpu")
        rres = search(x, rpool.ids, q, k=10, ef=EF, device="cpu")
        t3 = time.perf_counter()
        for impl, ids, pids, s in (
            ("jax reference", jid, pid, t1 - t0),
            ("port, plain versions", res.ids, pool.ids, t2 - t1),
            ("port, plain versions, the reference's draws", rres.ids, rpool.ids, t3 - t2),
        ):
            print(json.dumps({
                "impl": impl, "seed": seed, "ef": EF,
                "recall@10": recall_at_k(ids, truth),
                "excess": distance_excess(x, q, ids, truth, rq),
                "pool_recall@10": recall_at_k(pids[verts], vknn),
                "pool_excess": pool_excess(x, verts, pids, vknn, rv),
                "seconds": s,
            }), flush=True)


if __name__ == "__main__":
    main()
