"""kNN-LM on the PyTorch port: GRNND as the retrieval substrate of an LM.

The counterpart of `examples/knn_lm.py` without its training step: the LM
is gemma3-1b, randomly initialised (`reduced()` by default, the full width
with `--full`). The script

  1. harvests (post-`final_norm` hidden state, next token) pairs from
     synthetic Zipf token streams, each sequence's pairs tagged with one of
     four document sources;
  2. indexes them in a `DynamicDatastore` (GRNND build, then a dynamic index
     at int8 traversal with an fp32 rescore by default);
  3. generates with retrieval in the loop: the logit hook queries the index
     with every decode step's hidden state and fuses the vote into the
     logits, the token hook streams the generation's own pairs back in;
  4. compares pure-LM and kNN-fused NLL on stored pairs (the memorization
     win), and retrieves restricted to one source.

    PYTHONPATH=src python examples/knn_lm_torch.py --device cpu
    PYTHONPATH=src python examples/knn_lm_torch.py --full        # on a card
    PYTHONPATH=src python examples/knn_lm_torch.py --device cpu --engine --tier host
"""

import argparse
import time

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core import Draws, GRNNDConfig
from repro_torch.data.synthetic import token_stream
from repro_torch.models import transformer as T
from repro_torch.retrieval import knn_lm
from repro_torch.serve import ServeEngine

N_SOURCES = 4


def nll(logits, targets) -> float:
    lsm = torch.log_softmax(logits.float(), -1)
    return float(-lsm.gather(1, targets.long()[:, None]).mean())


def harvest(params, cfg, tokens, act_dtype, chunk: int):
    """(keys (B·(S-1), D) fp32, next tokens, sources) of every position but
    the last, `chunk` sequences a forward."""
    keys = []
    with torch.no_grad():
        for lo in range(0, tokens.shape[0], chunk):
            h, _ = T.forward(params, cfg, {"tokens": tokens[lo : lo + chunk]},
                             act_dtype=act_dtype, return_hidden=True)
            keys.append(h[:, :-1].float().reshape(-1, cfg.d_model))
    b, s = tokens.shape
    sources = (torch.arange(b, device=tokens.device) * N_SOURCES // b).repeat_interleave(s - 1)
    return torch.cat(keys), tokens[:, 1:].reshape(-1), sources.to(torch.int32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--full", action="store_true", help="gemma3-1b at full width (a card)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--precision", default="int8", choices=["fp32", "bf16", "int8"],
                    help="datastore traversal tier (int8 / bf16 rescore against fp32)")
    ap.add_argument("--tier", default="device", choices=["device", "host"],
                    help="fp32 rescore-tier placement (host needs a quantized traversal tier)")
    ap.add_argument("--engine", action="store_true",
                    help="route retrieval through the continuous-batching AnnEngine")
    ap.add_argument("--seqs", type=int, default=None, help="harvested sequences")
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--lam", type=float, default=0.25)
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = get_arch("gemma3-1b") if args.full else reduced(get_arch("gemma3-1b"))
    seqs = args.seqs or (256 if args.full else 32)
    seq_len = args.seq_len or (512 if args.full else 64)
    act_dtype = torch.bfloat16 if args.full else torch.float32
    build_cfg = knn_lm.DEFAULT_BUILD_CFG if args.full else GRNNDConfig(
        s=8, r=16, t1=2, t2=3, pairs_per_vertex=16)
    params = T.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(dev).manual_seed(1)
    tokens = token_stream(gen, seqs, seq_len, cfg.vocab)

    # 1-2. harvest and index
    t0 = time.perf_counter()
    keys, vals, sources = harvest(params, cfg, tokens, act_dtype, chunk=32)
    ds = knn_lm.DynamicDatastore.build(
        keys, vals, cfg.vocab, build_cfg=build_cfg, precision=args.precision, tier=args.tier,
        sources=sources, n_sources=N_SOURCES, draws=Draws(3, dev), device=dev, k=8, ef=32,
    )
    engine = ds.attach_engine() if args.engine else None
    print(f"datastore: {len(ds)} pairs of {cfg.name} (d={cfg.d_model}), precision="
          f"{args.precision} tier={args.tier} engine={int(args.engine)}; "
          f"{time.perf_counter() - t0:.2f}s")

    # 3. retrieval-fused generation, the new pairs streamed back in
    stream = knn_lm.make_stream_hook(ds, insert_every=4)
    eng = ServeEngine(cfg, params, s_max=16 + args.new_tokens, act_dtype=act_dtype,
                      logit_hook=knn_lm.make_logit_hook(ds, lam=args.lam), token_hook=stream,
                      device=dev)
    n0 = len(ds)
    out = eng.generate({"tokens": tokens[:4, :16]}, max_new_tokens=args.new_tokens)
    stream.flush()
    print(f"generated {tuple(out['tokens'].shape)} fused tokens; the datastore grew "
          f"{n0} -> {len(ds)} during decode")
    if engine is not None:
        s = engine.stats()
        print(f"engine: {s.n_completed} queries, {s.n_mutations} inserted, retrieval "
              f"p50 {s.p50_ms:.1f} ms, p99 {s.p99_ms:.1f} ms")

    # 4. pure vs fused NLL on stored pairs (positions >= 16: distinct prefixes)
    rows = torch.arange(8 * (seq_len - 1), device=dev)
    rows = rows[rows % (seq_len - 1) >= min(16, seq_len - 2)]
    q, tgt = keys[rows], vals[rows]
    lm = T.lm_logits(params, cfg, q)
    fused = knn_lm.fuse(lm, ds.knn_log_probs(q), lam=args.lam)
    pure_nll, fused_nll = nll(lm, tgt), nll(fused, tgt)
    print(f"pure-LM NLL   : {pure_nll:.4f}")
    print(f"kNN-fused NLL : {fused_nll:.4f}  (lam={args.lam})")

    # 5. provenance-scoped retrieval: source 0 only
    klp0 = ds.knn_log_probs(q[:64], filter=torch.zeros((q[:64].shape[0],), dtype=torch.int32))
    support = float(torch.isfinite(klp0).any(-1).float().mean())
    print(f"source-0 filtered retrieval: support on {support:.0%} of queries "
          f"(sources 0..{N_SOURCES - 1} indexed)")
    return {
        "pairs": n0,
        "grew": len(ds) - n0,
        "pure_nll": pure_nll,
        "fused_nll": fused_nll,
        "filtered_support": support,
        "device": str(dev),
    }


if __name__ == "__main__":
    main()
