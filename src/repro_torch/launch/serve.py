"""Serve batched ANN queries against a saved GRNND index, on the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --index /path/to/sift.idx.npz \
        [--device cuda] [--batches 8] [--ef 48] [--backend ref] [--visited hashed] \
        [--visited-cap 512] [--precision int8] [--tier host] [--optimize-layout bfs] \
        [--mutable --churn 64] [--filter-labels 100 --selectivity 0.1] \
        [--corpus-shards 4] [--engine --requests 256 --offered-qps 500 --mix-k 5,10]
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --index ... --shards 2

The port's counterpart of `repro.launch.serve`, with the same flags, modes,
rejections and stats line. The index file is the `np.savez` of `ids`,
`dists` and `x` that either package's `launch.build_index` writes. `main`
returns the numbers of its stats line as a dict (and, for the fixed-batch
modes, every measured batch's ids and dists).

The modes:

* the fixed-batch loop: `--batches` batches of `--batch-size` queries (a
  first batch more runs unmeasured, as the warm-up), recall@k against brute
  force; `--visited hashed` swaps the dense (Q, N) visited mask for the
  O(Q·H) per-query table;
* `--precision {fp32,bf16,int8}`: the traversal tier; a quantized one
  re-ranks the final ef candidates against the fp32 tier unless
  `--no-rescore`; `--tier host` keeps that fp32 tier in host memory
  (bitwise the device tier);
* `--optimize-layout {bfs,hub}`: the post-build layout pass, bitwise the
  plain index, ids in the original numbering;
* `--filter-labels L`: every vertex a label uniform in [0, L), every query
  a predicate allowing ~`--selectivity`·L labels; ef is raised to the
  over-fetch floor; `pred_ok=` (the share of returned ids that pass their
  predicate) must be 1.0, recall is against brute force over each query's
  allowed rows;
* `--corpus-shards S`: the corpus split by rows into S shards, bitwise the
  replicated search; the shards run on the first S ranks of the default
  process group when the run has one of at least S ranks, else all in this
  process (the in-process executor);
* `--shards K`: the queries split over the first K ranks of the default
  group (`core.distributed.distributed_search`, bitwise the single-process
  search). Under `torchrun` the CLI joins its group (NCCL on cards, one
  rank a card; gloo on the CPU); outside it, K = 1 runs a group of this
  process alone;
* `--mutable`: a `DynamicIndex` with per-batch churn: every batch first
  inserts `--churn` fresh vectors and deletes the `--churn` oldest live
  labels, then searches; recall is against brute force over the live
  corpus, and mutation throughput is reported beside the queries';
* `--engine`: the continuous-batching engine (`serve/ann_engine.py`): a
  synthetic open-loop trace of small requests (k and ef drawn per request
  from `--mix-k` / `--mix-ef`, every other request filtered under
  `--filter-labels`, a churn pair every `--churn-every` queries under
  `--mutable`); a closed-loop warm-up replay measures capacity (the default
  `--offered-qps` is 70% of it), then the measured replay reports p50 / p99
  latency, QPS, occupancy and the distinct batch shapes (`buckets=`).

The port's own flags: `--device` (default "cuda"; raises without a card),
`--backend {auto,ref}` (the kernels by the tensors' device, or the plain
PyTorch versions everywhere). Only rank 0 prints.

Synthetic draws come from `torch.Generator`s on the device, seeded as the
reference seeds its keys (100 + b for batch b, 1234 for the vertex labels,
9000 + `--trace-seed` for the engine's queries, churn and predicates),
each drawn in a fixed order; they are not the reference's numbers.
`synth_trace`'s arrivals and k / ef draws are, for the same `--trace-seed`.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch.core import brute_force_knn, layout, recall_at_k
from repro_torch.core import corpus_shard as CS
from repro_torch.core import labels as L
from repro_torch.core import vecstore as VS
from repro_torch.core.distributed import distributed_search
from repro_torch.core.dynamic import DynamicConfig, DynamicIndex
from repro_torch.core.pools import Pool
from repro_torch.core.search import medoid, overfetch_ef, search
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.launch import _group
from repro_torch.serve import ann_engine as AE


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--index", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--ef", type=int, default=48)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--backend", default=None, choices=["auto", "ref"],
                    help="kernel backend (default: the current one, REPRO_TORCH_BACKEND or auto)")
    ap.add_argument("--visited", default="dense", choices=["dense", "hashed"])
    ap.add_argument("--visited-cap", type=int, default=None,
                    help="hashed-table slots per query (default: default_visited_cap(ef))")
    ap.add_argument("--shards", type=int, default=0,
                    help="split query batches over this many ranks (0 = one process)")
    ap.add_argument("--corpus-shards", type=int, default=0,
                    help="split the CORPUS into this many shards (0 = replicated)")
    ap.add_argument("--precision", default="fp32", choices=list(VS.PRECISIONS))
    ap.add_argument("--no-rescore", action="store_true",
                    help="skip the fp32 re-rank (quantized precisions only)")
    ap.add_argument("--tier", default="device", choices=list(VS.PLACEMENTS),
                    help="fp32 rescore-tier placement: 'host' keeps it in host memory")
    ap.add_argument("--mutable", action="store_true",
                    help="serve through a DynamicIndex with per-batch insert / delete churn")
    ap.add_argument("--churn", type=int, default=None,
                    help="vectors inserted AND deleted per batch (only with --mutable)")
    ap.add_argument("--refine-rounds", type=int, default=None,
                    help="localized rounds per insert batch (only with --mutable; default 2)")
    ap.add_argument("--optimize-layout", default=None, choices=list(layout.ORDERS))
    ap.add_argument("--filter-labels", type=int, default=0,
                    help="filtered serving over synthetic labels in [0, L) (0 = unfiltered)")
    ap.add_argument("--selectivity", type=float, default=None,
                    help="share of the label space a predicate allows (default 0.1)")
    ap.add_argument("--engine", action="store_true",
                    help="serve a request trace through the continuous-batching engine")
    ap.add_argument("--offered-qps", type=float, default=None,
                    help="trace arrival rate (only with --engine; default 0.7 x capacity)")
    ap.add_argument("--requests", type=int, default=256,
                    help="trace length in queries (only with --engine)")
    ap.add_argument("--trace-seed", type=int, default=0)
    ap.add_argument("--mix-k", default="5,10", help="the trace's k menu (only with --engine)")
    ap.add_argument("--mix-ef", default=None,
                    help="the trace's ef menu (only with --engine; default: just --ef)")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--quantum", type=int, default=4,
                    help="query batches per mutation when both queues are backed up")
    ap.add_argument("--max-pending", type=int, default=1024,
                    help="admission-control queue bound (excess requests are shed)")
    ap.add_argument("--churn-every", type=int, default=32,
                    help="queries between churn events in the trace (--engine --mutable)")
    return ap


def _check(ap: argparse.ArgumentParser, args) -> None:
    """The reference's rejections, and the port's for --shards."""
    if args.visited_cap is not None and args.visited != "hashed":
        ap.error("--visited-cap only applies with --visited hashed "
                 "(dense mode would silently ignore it)")
    world = _group.world_size()
    if args.shards > max(world, 1):
        ap.error(f"--shards {args.shards} exceeds the {world} rank(s) of this run; launch "
                 f"with torchrun --nproc-per-node {args.shards} (one rank a card on NCCL)")
    if args.shards > 0 and args.mutable:
        ap.error("--mutable serves in one process (the mutation path is not "
                 "query-sharded); drop --shards")
    if args.corpus_shards > 0 and args.shards > 0:
        ap.error("--corpus-shards and --shards pick one sharding axis per run")
    if args.corpus_shards > 0 and args.mutable:
        ap.error("--mutable serves the replicated layout; use "
                 "DynamicIndex.corpus_search for corpus-sharded mutation serving")
    if not args.mutable and (args.churn is not None or args.refine_rounds is not None):
        ap.error("--churn/--refine-rounds only apply with --mutable")
    if args.no_rescore and args.precision == "fp32":
        ap.error("--no-rescore only applies with --precision bf16/int8 "
                 "(fp32 traversal is already exact)")
    if args.tier == "host" and args.precision == "fp32":
        ap.error("--tier host places the fp32 RESCORE tier; at --precision fp32 the "
                 "fp32 rows ARE the traversal tier and stay on the device")
    if args.tier == "host" and args.no_rescore:
        ap.error("--tier host without a rescore pass places nothing; drop --no-rescore")
    if args.selectivity is not None and not args.filter_labels:
        ap.error("--selectivity only applies with --filter-labels")
    if args.filter_labels and not (args.selectivity is None or 0 < args.selectivity <= 1):
        ap.error("--selectivity must be in (0, 1]")
    if args.engine and args.shards > 0:
        ap.error("--engine shapes its own batches; query-sharding a dynamic batch "
                 "needs a custom worker (drop --shards)")
    if not args.engine and (args.offered_qps is not None or args.mix_ef is not None):
        ap.error("--offered-qps/--mix-ef only apply with --engine")
    if args.engine and args.mutable and args.corpus_shards > 0:
        ap.error("--engine --mutable serves the replicated layout")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _gen(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(dev).manual_seed(seed)


def main(argv=None) -> dict:
    ap = _parser()
    args = ap.parse_args(argv)
    _check(ap, args)
    dev = _device.resolve(args.device)
    made, group = False, None
    on_ranks = args.shards > 0 or (
        args.corpus_shards > 0 and _group.launched()
        and _group.world_size() >= args.corpus_shards
    )
    try:
        if on_ranks:
            dev, made = _group.join(dev)
            group = _group.first_ranks(args.shards or args.corpus_shards)
            if group is None:
                return {}  # a rank outside the sharded run's ranks
        with ops.backend(args.backend or ops.get_backend()):
            return _serve(args, dev, group)
    finally:
        if made:
            dist.destroy_process_group()


def _serve(args, dev: torch.device, group) -> dict:
    blob = np.load(args.index)
    x = _device.put(blob["x"], torch.float32, dev)
    ids = _device.put(blob["ids"], torch.int32, dev)
    if args.engine:
        return serve_engine(args, dev, x, blob, ids, group)
    if args.mutable:
        return serve_mutable(args, dev, x, _device.put(blob["dists"], torch.float32, dev), ids)

    setup = _static_setup(args, dev, x, ids, group)
    lstore, sel, ef = setup["lstore"], setup["sel"], setup["ef"]
    kw = dict(k=args.k, ef=ef, visited=args.visited, visited_cap=args.visited_cap)

    def run_batch(q, fw):
        if setup["cs_idx"] is not None:
            return setup["cs_idx"].search(q, filter=fw, group=setup["cs_group"], **kw)
        kw2 = dict(kw, entry=setup["entry"], rescore=setup["rescore"], ids_map=setup["ids_map"],
                   device=dev)
        if lstore is not None:
            kw2.update(labels=setup["words"], filter=fw)
        if args.shards > 0:
            return distributed_search(setup["xt"], setup["ids"], q, group=group, **kw2)
        return search(setup["xt"], setup["ids"], q, **kw2)

    lat, recs, preds, got_ids, got_dists = [], [], [], [], []
    for b in range(args.batches + 1):
        g = _gen(dev, 100 + b)
        q = synthetic.queries_from(g, x, args.batch_size)
        fw = None
        if lstore is not None:
            fw = L.random_query_filters(g, args.batch_size, args.filter_labels, sel)
        _sync(dev)
        t0 = time.perf_counter()
        res = run_batch(q, fw)
        _sync(dev)
        dt = time.perf_counter() - t0
        if b == 0:
            continue  # the warm-up batch
        lat.append(dt)
        got_ids.append(res.ids.cpu().numpy())
        got_dists.append(res.dists.cpu().numpy())
        if lstore is None:
            recs.append(recall_at_k(res.ids, brute_force_knn(x, q, args.k, device=dev)))
        else:
            # recall against brute force over each query's ALLOWED rows, and
            # the hard invariant: every returned id passes its predicate
            gt = L.filtered_brute_force(x, q, fw, lstore.words, args.k)
            recs.append(L.filtered_recall_at_k(res.ids, gt))
            preds.append(L.predicate_fraction(res.ids, fw, lstore.words))

    out = {
        "qps": args.batch_size / (sum(lat) / len(lat)),
        "p50_ms": sorted(lat)[len(lat) // 2] * 1e3,
        "recall": sum(recs) / len(recs),
    }
    extra = ""
    if lstore is not None:
        out.update(selectivity=sel, pred_ok=sum(preds) / len(preds), ef=ef)
        extra = (f"filtered=1  selectivity={sel:g}  pred_ok={out['pred_ok']:.3f}  "
                 f"ef={ef}  ")
    line = (
        f"qps={out['qps']:.0f}  p50={out['p50_ms']:.1f}ms  "
        f"recall@{args.k}={out['recall']:.3f}  {extra}"
        f"backend={ops.effective_backend(dev)}  visited={args.visited}  "
        f"precision={args.precision}  bpv={setup['bpv']:.0f}  "
        f"rescore={int(setup['rescore'] is not None)}  tier={args.tier}  "
        f"opt_layout={args.optimize_layout or 'none'}  shards={max(args.shards, 1)}  "
        f"corpus_shards={max(args.corpus_shards, 1)}  device={dev}"
    )
    return _report(line, out, np.stack(got_ids), np.stack(got_dists))


def _report(line: str, out: dict, ids=None, dists=None) -> dict:
    """Print the stats line (rank 0 only); the stats as a dict."""
    out["line"] = line
    if ids is not None:
        out.update(ids=ids, dists=dists)
    if _group.rank() == 0:
        print(line, flush=True)
    return out


def serve_engine(args, dev, x, blob, ids, group) -> dict:
    """--engine: a synthetic open-loop trace through the continuous-batching
    engine. A closed-loop warm-up replay of the whole trace measures the
    engine's capacity (the default --offered-qps is 70% of it); the
    measured replay then reports p50 / p99 latency, QPS, occupancy and the
    distinct batch shapes."""
    k_choices = [int(s) for s in args.mix_k.split(",") if s.strip()]
    ef_choices = [int(s) for s in args.mix_ef.split(",") if s.strip()] if args.mix_ef else [args.ef]
    cfg = AE.EngineConfig(
        max_pending=args.max_pending,
        max_batch=args.max_batch,
        query_quantum=args.quantum,
        ef_menu=tuple(sorted(set(ef_choices))),
    )
    if max(k_choices) > min(cfg.k_cap, min(ef_choices)):
        raise SystemExit(f"--mix-k max {max(k_choices)} exceeds "
                         f"min(k_cap={cfg.k_cap}, ef={min(ef_choices)})")

    g = _gen(dev, 9000 + args.trace_seed)
    q = synthetic.queries_from(g, x, args.requests).cpu().numpy()
    mut_every, churn_vecs, churn_labs = 0, None, None
    if args.mutable:
        lstore, sel, _ = _filter_setup(args, dev, x.shape[0])
        idx = _dynamic_index(args, dev, x, _device.put(blob["dists"], torch.float32, dev), ids,
                             lstore)
        worker = AE.DynamicWorker(idx, visited=args.visited, visited_cap=args.visited_cap)
        churn = args.churn if args.churn is not None else 16
        mut_every = args.churn_every
        n_churn = max(1, args.requests // max(mut_every, 1))
        churn_vecs = [
            synthetic.queries_from(g, x, churn, noise=0.1).cpu().numpy() for _ in range(n_churn)
        ]
        if lstore is not None:
            churn_labs = [
                torch.randint(0, args.filter_labels, (churn,), generator=g, device=dev)
                .to(torch.int32).cpu().numpy()
                for _ in range(n_churn)
            ]
    else:
        setup = _static_setup(args, dev, x, ids, group)
        lstore, sel = setup["lstore"], setup["sel"]
        if setup["cs_idx"] is not None:
            worker = AE.ShardedWorker(setup["cs_idx"], group=setup["cs_group"],
                                      visited=args.visited, visited_cap=args.visited_cap)
        else:
            worker = AE.StaticWorker(
                setup["xt"], setup["ids"], entry=setup["entry"], visited=args.visited,
                visited_cap=args.visited_cap, rescore=setup["rescore"], labels=setup["words"],
                ids_map=setup["ids_map"], device=dev,
            )

    # every other request filtered (a mixed-predicate stream), the rest plain
    fwords = None
    if lstore is not None:
        fw = L.random_query_filters(g, args.requests, args.filter_labels, sel).cpu().numpy()
        fwords = [fw[i] if i % 2 == 0 else None for i in range(args.requests)]

    def make_trace(offered):
        return AE.synth_trace(
            np.random.default_rng(args.trace_seed), q, offered_qps=offered,
            k_choices=k_choices, ef_choices=ef_choices, fwords=fwords,
            mutation_every=mut_every, churn_vectors=churn_vecs, churn_labels=churn_labs,
        )

    eng = AE.AnnEngine(worker, cfg)
    # closed-loop warm-up: everything arrives at t = 0, so every batch shape
    # runs once here and the drain rate is the engine's capacity
    warm = AE.replay(eng, [dataclasses.replace(ev, t=0.0) for ev in make_trace(1.0)])
    for rid in warm.values():
        eng.take_result(rid)
    capacity = max(eng.stats().qps, 1.0)
    eng.reset_stats()

    offered = args.offered_qps if args.offered_qps is not None else 0.7 * capacity
    trace = make_trace(offered)
    rids = AE.replay(eng, trace)
    s = eng.stats()
    out = dict(s._asdict(), capacity=capacity, offered=offered)
    extra = ""
    if args.mutable:
        out["live"] = idx.n_live
        extra = f"mutations/s={s.mutations_per_sec:.0f}  live={idx.n_live}  "
    else:
        out.update(_engine_recall(trace, rids, eng, q, x, lstore, k_choices, dev))
        extra = f"recall={out['recall']:.3f}  "
        if out["pred_ok"] is not None:
            extra += f"pred_ok={out['pred_ok']:.3f}  "
    line = (
        f"engine=1  qps={s.qps:.0f}  offered={offered:.0f}  "
        f"p50={s.p50_ms:.1f}ms  p99={s.p99_ms:.1f}ms  "
        f"occupancy={s.mean_occupancy:.2f}  buckets={s.n_buckets}  "
        f"completed={s.n_completed}  rejected={s.n_rejected}  {extra}"
        f"backend={ops.effective_backend(dev)}  visited={args.visited}  "
        f"precision={args.precision}  tier={args.tier}  mutable={int(args.mutable)}  "
        f"corpus_shards={max(args.corpus_shards, 1)}  capacity={capacity:.0f}  device={dev}"
    )
    return _report(line, out)


def _engine_recall(trace, rids, eng, q, x, lstore, k_choices, dev) -> dict:
    """recall of every admitted request against brute force (over its
    allowed rows when filtered), and the filtered requests' predicate
    fraction (None without any)."""
    row_of = {ti: j for j, ti in enumerate(i for i, ev in enumerate(trace) if ev.kind == "query")}
    kmax = max(k_choices)
    got = {ti: eng.take_result(rid) for ti, rid in rids.items()}
    plain = [ti for ti in got if trace[ti].fwords is None]
    filt = [ti for ti in got if trace[ti].fwords is not None]
    recs, preds = [], []
    if plain:
        rows = torch.from_numpy(q[[row_of[ti] for ti in plain]])
        gt = brute_force_knn(x, rows, kmax, device=dev).cpu().numpy()
        for j, ti in enumerate(plain):
            k = trace[ti].k
            recs.append(recall_at_k(got[ti].ids[None], gt[j, :k][None]))
    if filt:
        rows = _device.put(q[[row_of[ti] for ti in filt]], torch.float32, dev)
        fw = _device.put(np.stack([trace[ti].fwords for ti in filt]), torch.int32, dev)
        gt = L.filtered_brute_force(x, rows, fw, lstore.words, kmax).cpu().numpy()
        for j, ti in enumerate(filt):
            k = trace[ti].k
            recs.append(L.filtered_recall_at_k(got[ti].ids[None], gt[j, :k][None]))
            preds.append(L.predicate_fraction(torch.from_numpy(got[ti].ids[None]).to(dev),
                                              fw[j : j + 1], lstore.words))
    return {
        "recall": sum(recs) / max(len(recs), 1),
        "pred_ok": sum(preds) / len(preds) if preds else None,
    }


def _static_setup(args, dev, x, ids, group) -> dict:
    """The frozen-index serving operands, shared by the fixed-batch loop and
    the engine's static and sharded workers: the precision ladder, the
    filter labels, the optional layout pass and corpus sharding."""
    # traversal reads the compact tier; the fp32 rows stay as the rescore tier
    store = VS.encode(x, args.precision)
    xt = x if args.precision == "fp32" else store
    rescore = x if (args.precision != "fp32" and not args.no_rescore) else None
    bpv = store.bytes_per_vector()
    entry = medoid(xt)
    lstore, sel, ef = _filter_setup(args, dev, x.shape[0])
    words = None if lstore is None else lstore.words
    ids_map = None
    if args.optimize_layout:
        # every index-side operand is permuted together and `ids_map`
        # restores the original numbering on the way out
        opt = layout.optimize(xt, ids, order=args.optimize_layout, rescore=rescore,
                              labels=words, entry=entry, device=dev)
        xt, ids, entry, rescore, ids_map = opt.x, opt.graph_ids, opt.entry, opt.rescore, opt.inv
        if words is not None:
            words = opt.vwords
    cs_idx = cs_group = None
    if args.corpus_shards > 0:
        # shards slice the (permuted) rows; --tier host keeps the rescore
        # tier whole in host memory
        cs_idx = CS.shard(xt, ids, args.corpus_shards, rescore=rescore, labels=words,
                          ids_map=ids_map, entry=entry, tier=args.tier, device=dev)
        cs_group = group
    elif args.tier == "host" and rescore is not None:
        # after the layout pass, so the host rows are the permuted ones
        rescore = VS.HostTier(rescore)
    return dict(xt=xt, ids=ids, entry=entry, rescore=rescore, bpv=bpv, lstore=lstore, sel=sel,
                ef=ef, words=words, ids_map=ids_map, cs_idx=cs_idx, cs_group=cs_group)


def _filter_setup(args, dev, n: int):
    """(LabelStore | None, selectivity, effective ef) of filtered serving:
    synthetic vertex labels (the saved index carries none) and the ef
    raised to the over-fetch floor."""
    if not args.filter_labels:
        return None, None, args.ef
    vlab = torch.randint(0, args.filter_labels, (n,), generator=_gen(dev, 1234), device=dev)
    lstore = L.encode_labels(vlab, args.filter_labels)
    sel = args.selectivity if args.selectivity is not None else 0.1
    return lstore, sel, overfetch_ef(n, args.k, sel, ef=args.ef)


def _dynamic_index(args, dev, x, dists, ids, lstore) -> DynamicIndex:
    rounds = args.refine_rounds if args.refine_rounds is not None else 2
    return DynamicIndex(
        x,
        Pool(ids, dists),
        DynamicConfig(refine_rounds=rounds, precision=args.precision, tier=args.tier,
                      layout=args.optimize_layout),
        vertex_labels=None if lstore is None else lstore.labels,
        n_labels=args.filter_labels if lstore is not None else None,
        device=dev,
    )


def serve_mutable(args, dev, x, dists, ids) -> dict:
    """--mutable: per-batch insert / delete churn through a DynamicIndex.
    Batch 0 is the unmeasured warm-up; a capacity doubling or compaction
    later in the run lands in that batch's latency."""
    lstore, sel, ef = _filter_setup(args, dev, x.shape[0])
    nl = args.filter_labels
    idx = _dynamic_index(args, dev, x, dists, ids, lstore)
    churn = args.churn if args.churn is not None else 64
    mut_lat, lat, recs, preds, got_ids, got_dists = [], [], [], [], [], []
    for b in range(args.batches + 1):
        g = _gen(dev, 100 + b)
        _sync(dev)
        t0 = time.perf_counter()
        if churn > 0:
            new = synthetic.queries_from(g, x, churn, noise=0.1)
            vl = None
            if lstore is not None:
                vl = torch.randint(0, nl, (churn,), generator=g, device=dev)
            idx.insert(new, vertex_labels=vl)
            idx.delete(idx.oldest_live(churn))
        _sync(dev)
        t_mut = time.perf_counter() - t0

        q = synthetic.queries_from(g, x, args.batch_size)
        fw = None if lstore is None else L.random_query_filters(g, args.batch_size, nl, sel)
        _sync(dev)
        t0 = time.perf_counter()
        res = idx.search(q, k=args.k, ef=ef, visited=args.visited, visited_cap=args.visited_cap,
                         rescore=False if args.no_rescore else None, filter=fw)
        _sync(dev)
        dt = time.perf_counter() - t0
        if b == 0:
            continue  # the warm-up batch
        mut_lat.append(t_mut)
        lat.append(dt)
        got_ids.append(res.ids.cpu().numpy())
        got_dists.append(res.dists.cpu().numpy())
        gt = idx.exact_knn(q, args.k, filter=fw)
        if lstore is None:
            recs.append(recall_at_k(res.ids, gt))
        else:
            recs.append(L.filtered_recall_at_k(res.ids, gt))
            # the hard invariant, from label space back to slots: every
            # returned label's slot passes its predicate
            table, sorter = torch.sort(idx.labels[: idx.size], stable=True)
            pos = torch.searchsorted(table, res.ids.clamp_min(0)).clamp_max(idx.size - 1)
            slots = torch.where(res.ids >= 0, sorter[pos], -1)
            preds.append(L.predicate_fraction(slots, fw, idx.label_words()))

    out = {
        "qps": args.batch_size / (sum(lat) / len(lat)),
        "p50_ms": sorted(lat)[len(lat) // 2] * 1e3,
        "recall": sum(recs) / len(recs),
        "mutations_per_sec": 2 * churn / (sum(mut_lat) / len(mut_lat)) if churn else 0.0,
        "live": idx.n_live,
    }
    extra = ""
    if lstore is not None:
        out.update(selectivity=sel, pred_ok=sum(preds) / len(preds), ef=ef)
        extra = (f"filtered=1  selectivity={sel:g}  pred_ok={out['pred_ok']:.3f}  "
                 f"ef={ef}  ")
    line = (
        f"qps={out['qps']:.0f}  p50={out['p50_ms']:.1f}ms  "
        f"recall@{args.k}={out['recall']:.3f}  {extra}"
        f"mutations/s={out['mutations_per_sec']:.0f}  churn={churn}  "
        f"live={idx.n_live}  tomb={idx.tombstone_fraction:.2f}  rounds={idx.rounds_run}  "
        f"backend={ops.effective_backend(dev)}  visited={args.visited}  "
        f"precision={args.precision}  tier={args.tier}  "
        f"opt_layout={args.optimize_layout or 'none'}  mutable=1  corpus_shards=1  device={dev}"
    )
    return _report(line, out, np.stack(got_ids), np.stack(got_dists))


if __name__ == "__main__":
    main()
