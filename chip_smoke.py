#!/usr/bin/env python3
"""Drive the PyTorch port's GRNND build, beam search, dynamic index, filtered
search, host rescore tier, layout pass, sharded searches, serving layer,
kNN-LM retrieval in an LM's decode loop, every LM family, training, and the
multi-rank training pieces (gradient compression, the fault-tolerance
supervisor, the expert-parallel MoE) and the production-mesh dry-run on one
NVIDIA card.

    python3 chip_smoke.py          # from the repository root, on a machine with a card
    python3 chip_smoke.py --knn-states chiprun_out/knn_states.npz   # also save 4i's witness states

Phases, each printing its own lines with seconds:

  1. device: the card's name and power limit, the torch / CUDA versions, and
     the kernels built from `src/repro_torch/kernels/csrc` (one nvcc each,
     all started together);
  2. each hand-written kernel, and each storage (bf16, int8), tombstone and
     label-filter variant, against its plain PyTorch version on the same CUDA inputs, at
     the shapes the SIFT1M-shaped paths give it (`gather_sqdist` also at fp32
     on the sharded build's merge pairs, `search_expand` also as one shard
     of the corpus-sharded search runs it), with kernel / plain /
     library times and the least time the card could take (bytes over
     3.35 TB/s or fp32 operations over 67 TFLOP/s); `topr_merge` also at the
     beam merges' shapes (W = 112, 176, 448, 560) and, carrying the expanded
     flags as the search does, at W = 112, `pairwise_sqdist` also at
     the medoid's M = 1, with cuBLAS SGEMM (TF32 off) timed beside the
     ground-truth row as the fp32 GEMM yardstick, and `gather_sqdist` beside a
     second bound on its log line, its neighbor rows as gathered (its library
     time is the gathered expression `(x[ni] - x[nj]).square().sum(-1)`, in
     chunks of 2^22 pairs); after
     phase 4's counts are read, `visited_insert` on every insert of one
     hashed search of the phase-4 graph at ef 64, 128 and 512 (tables of
     512, 1024 and 4096 slots), replayed and held exactly against its column
     loop after each launch;
  3. parity at n = 100,000: one fp32 build and one int8 build (searched with
     an fp32 rescore) through the kernels, each again through
     `ops.backend("ref")` with the same draws; recall@10 at ef = 64 over
     1,000 queries agrees within 0.01;
  3b. the sorted-order ablation (paper Alg. 2, Fig. 7,
     `benchmarks/fig7_order.py`), run after phase 4, whose truth it uses:
     an ascending and a descending build at phase 4's shape and build
     config, build seconds and recall@10 at ef 64 (hashed) beside the
     disordered build's, each above a floor that catches a broken graph;
  4. the main path at SIFT1M's shape (`sift-like`, n = 1,000,000, d = 128,
     10,000 queries, the SIFT1M build config): build, brute-force ground
     truth, hashed-visited search at ef 64 and 128 (one visited insert a
     step, plus one for the entry); every kernel must have launched, and
     recall@10 must clear a floor that catches a broken graph;
  4b. the dynamic index at int8 traversal with an fp32 rescore tier on the
     same corpus: build on rows [0, 900,000), construct (the int8 re-base),
     insert the last 100,000 rows in 10 batches of 10,000, search, delete
     100,000 labels, search again, compact; recall@10 must clear 0.50, no
     deleted label may come back, and a dense search of 1,000 queries must
     return identical ids before and after compaction;
  4c. the bf16 path, whose launches the bf16 rows report: the same build on
     rows [0, 900,000), a dynamic index at bf16 traversal (the bf16 re-base),
     the same 10 insert batches, and a search with the fp32 rescore;
     recall@10 must clear the floor of 4b;
  4d. filtered search and the layout pass on the phase-4 fp32 graph: vertex
     labels uniform over 100 labels, 10,000 queries with predicates at
     selectivities 0.5 / 0.1 / 0.01, each searched hashed at
     ef = overfetch_ef(n, 10, s, 64); the predicate fraction must be exactly
     1.0 and filtered recall@10 (against `filtered_brute_force`) must clear
     its floor. Then `optimize(order="bfs")`: a dense search of 1,000
     queries with and without the layout, unfiltered and filtered at
     s = 0.1, must return bitwise-equal ids and dists; hashed QPS at ef 64
     with and without it;
  4e. the labeled dynamic index at int8 traversal with the fp32 rescore
     tier in pinned host memory and the BFS layout: build on rows
     [0, 900,000), insert the last 100,000 with their labels in 10
     batches, a filtered search at s = 0.1 that must equal bitwise the same
     search with the device fp32 tier as `rescore`, delete 100,000 labels,
     `compact()` (which re-runs the layout), search filtered again: no
     deleted label, predicate fraction 1.0, no rescore byte on the card;
  4f. corpus sharding at S = 4 (fig13's protocol,
     `benchmarks/fig13_corpus_sharded.py:86`: merge_rounds 5, 8 cross
     candidates): `sharded_build` of the n = 10^6 corpus (build seconds;
     recall@10 through the sharded search at ef 64 above a floor); the
     phase-4 graph `shard()`ed: the hashed ef-64 `sharded_search` of the
     10,000 queries bitwise phase 4's search (ids, dists, n_expanded), the
     filtered search at s = 0.1 bitwise 4d's, and 4b's index's
     `corpus_search` bitwise its `search` in label space; `memory_report`'s
     per-shard and replicated bytes and the peak card memory;
  4g. `torch.distributed` at world size 1 on NCCL (a HashStore rendezvous,
     no port): `distributed_search` and `corpus_sharded_search` bitwise the
     same searches without a group, one `DynamicIndex(group=)` insert batch
     giving the in-process index's pool, and `sharded_build_graph`
     (allgather) at phase 3's n = 100,000 within 0.02 recall@10 of phase
     3's fp32 build;
  4h. serving, after phase 5 (whose insert it follows): the continuous-batching
     engine (`serve/ann_engine.py`) at fig14's full-scale menu (k 5 / 10,
     ef 32 / 64, batches of up to 32, `benchmarks/fig14_serving.py:79`),
     each worker as `serve --engine` drives it (a closed-loop replay for the
     capacity, then an open-loop replay at 0.7 x capacity): the static
     worker over phase 4's graph and 5,000 of its queries, every other request
     filtered at s = 0.1 against 4d's labels, each result bitwise its row of
     one direct search per (ef, filtered) group and the first 64 of Q = 1
     searches, predicate fraction exactly 1.0; the dynamic worker on 4b's
     int8 index, 1,024 requests with a churn pair of 16 every 32, the log
     replayed on a twin index from the same state (every result, the pool,
     labels and validity bitwise); the sharded worker at S = 4 on the static
     trace's first 1,024 requests unfiltered, bitwise the replicated search;
     then the serving CLI (`launch/serve.py`) in process on a sift-small
     index that `launch/build_index.py` builds into `build/serve_cli/`, one
     run a mode (static, filtered, int8 + host tier, layout, corpus shards,
     int8 mutable churn, the engine, `--shards 1` on NCCL): every stats line
     parses and `pred_ok` is 1.0;
  4i. kNN-LM at gemma3-1b's full width, after phase 4h (random weights from
     the seed, fp32 master weights, bf16 activations): 2,051 sequences of
     512 Zipf tokens through `forward(return_hidden=True)`, 1,046,528
     (post-`final_norm` hidden, next token) pairs of 2,048 of them in a
     `DynamicDatastore` (GRNND build with `DEFAULT_BUILD_CFG`, int8
     traversal + fp32 rescore, 4 source labels, k 8, ef 32, hashed visited
     set); the states' geometry and the pools' true-neighbor share; recall@10
     and the distance excess (0 at the true neighbors, ~1 at random rows)
     of 1,000 held-out states at ef 32 / 128 / 512; at ef 32 the kernels'
     excess within 0.01 of the plain versions' and 5 gaps under a random
     graph's (and the pools' under random pools'); builds of the first
     2^18 pairs at two seeds through both, each within 0.01 in pool and
     search excess; the witness subset (2^14 keys) built and searched
     through both at three seeds, which `--knn-states` saves for
     the JAX reference on the CPU (`tests/_knn_witness.py`); 4,096 stored keys as
     queries: where the own row is retrieved the vote picks its token (>=
     0.99), the fused NLL stays within -log(1 - lam) of the pure LM's and
     beats it on those queries; the fp32 datastore on 2^18 pairs bitwise
     `knn_logits` on the array-backed store; `attach_engine()` retrieval of
     256 queries bitwise the direct search; a source-filtered retrieval;
     `ServeEngine` generation of 32 prompts x (128 + 64) greedy tokens with
     both hooks, the datastore growing by 2,048, replayed on a twin from the
     same state (tokens, pools, labels, validity and token table bitwise),
     and without the hooks; every kernel call of one streaming insert and
     one decode step's retrieval held against its plain version; then phase
     2's rows at D = 1152 (B1 fp32 at C = N and int8 at an insert's
     frontier, B3 int8 + valid and fp32 + valid at Q = 32 and 1,000, B6 int8
     and fp32 at M = N·24, B4 at the init's block, B5 at the medoid and the
     truth);
  4j. kNN-LM at deepseek-moe-16b's full width (28 layers, d_model 2048, 64
     routed experts top-6 + 2 shared, a dense first layer; bf16 random
     weights, bf16 activations): 1,027 sequences of 512 Zipf tokens, 64 a
     forward, with each MoE layer's drop share; 523,264 pairs at D = 2048
     in 4i's datastore config; the excess of the kernels within 0.01 of the
     plain versions' and 5 gaps under a random graph's and random pools';
     the own-row votes on stored keys; the generation with both hooks
     bitwise a twin's and without them; one decode step under the profiler;
     every kernel call of one streaming insert and one decode step's
     retrieval held against its plain version; phase 2's rows at D = 2048,
     B1's direct reads forced beside its staged row (bitwise);
  4k. the other families from bf16 random weights, one on the card at a
     time: mamba2-130m, zamba2-7b (81 layers, one shared attention block at
     13 positions), musicgen-large (4 codebooks), internvl2-2b (256 patch
     embeddings of width 1024 before the text), gemma2-2b, h2o-danube-1.8b
     and gemma3-27b (62 layers, 54 GB) at full depth and width, and
     qwen3-moe-235b-a22b at full width cut to 4 layers: 8 prompts x 128
     tokens and 32 greedy steps, (a) a second generation bitwise the first,
     (b) the decode step's logits within 5e-3 of the forward's last
     position (fp32 activations, MoE capacity 16); a datastore over 16
     sequences of zamba2's and qwen3's states, whose fp32 build runs B1's
     direct-read path (D = 3584, 4096), every kernel call held against its
     plain version; (c) `_ssd_chunked` (fp32) against `ssd_naive` run in
     fp64 at zamba2's shapes within 1e-4, (d) `moe_block` at deepseek's
     shapes against a
     per-token loop over 64 tokens (no drops) within 2e-3; first, phase 2's
     rows of B1's direct-read path at D = 3584 and 4096 (C = 2^17, R = P =
     24);
  4l. training, after 4k: gemma3-1b at full width (26 layers, d_model
     1152, vocab 262,144) from `init_params(seed=0)` through
     `launch.train.train`: fp32 master weights, bf16 activations, remat
     "full", CE chunks of 512, batch 8 x 512 of `data.pipeline` batches,
     AdamW at lr 3e-4; the first and last loss (the last at least 0.3
     below the first), tokens/s, seconds a step and the peak memory; the
     bitwise resume (gemma3-1b cut to 8 layers at full width: k steps,
     `checkpoint.save`, `restore` into a fresh state, m more, against k + m
     straight, every parameter and moment bitwise, under
     `torch.use_deterministic_algorithms`); one training step of each of the
     ten families at reduced() width against the same step on the CPU port;
     then 4i's datastore (1,046,528 pairs, the same config) over the
     trained model's states of fresh sequences, with 4i's checks, its
     recall@10 at ef 32 and memorization share printed against the floors
     0.40 and 0.90 (an unmet floor is printed as unmet: `token_stream`
     draws each position independently);
  4m. the multi-rank training pieces, after 4l, on an NCCL group of world
     size 1 (`launch/_group.join`): one gradient of 4l's trained gemma3-1b
     (batch 8 x 512) through `compressed_psum_mean`, q and the scales of a
     few leaves bitwise the CPU port's, every leaf bitwise its dequantized
     int8 (within half a quantization step), its time, the bytes it
     all-reduces and their share of a 4l step, one `ErrorFeedback.compress`;
     on 4l's resume model under deterministic algorithms, 3 steps of
     `make_train_step(compress_pod_grads=True)` bitwise 3 plain steps on the
     quantized gradients, the loss lower after 20, and `TrainingSupervisor`
     over 4 simulated hosts (a checkpoint every 5 steps under build/, a host
     lost before step 7) bitwise 10 straight steps, with its restart's cost;
     deepseek-moe-16b's MoE layer (8 x 512 tokens, fp32, capacity 16) under
     `use_hints(make_debug_mesh((1, 1)))` against the dense path: output
     within 1e-5 of its largest magnitude, every gradient of sum(y^2) within
     1e-3, no drops, both paths' times and peak memory;
  4n. the production-mesh dry-run, after 4m (`launch/dryrun.py`, over fake
     process groups): the GRNND cells (`build_1m_d128`, `build_1m_d960`:
     one rank's a2a build round on the card, n = 2^20) over 256 and 512
     ranks and over 16 and 32 under REPRO_TORCH_MESH_OVERRIDE "4,4" /
     "2,4,4", each with its all-to-all bytes (exactly 3·S·cap·4), argument
     bytes, peak memory and round time, then B1 and B2 held against their
     plain versions at each cell's shapes; 4l's train step traced on meta
     at a (1, 1) mesh, whose FLOPs and argument bytes must equal one real
     step's `FlopCounterMode` count and resident bytes, its predicted peak
     printed beside the measured one; one train_4k cell a policy on the
     16 x 16 group (mamba2-130m dp_only, gemma2-2b tp, gemma3-27b zero1,
     qwen3-moe-235b-a22b fsdp) and gemma2-2b long_500k, on CUDA ranks,
     mamba2, gemma3-27b and qwen3-moe cut to their 1- and 2-unit probes
     (their whole traces take 45-60 s each; `tools/dryrun_sweep.sh` runs
     every cell whole), gemma2-2b's train cell traced whole and by its
     probes, which must agree;
  5. where the time goes: torch.profiler over one propagation round, one
     hashed search (with the summed device time of `search_expand` and of
     `visited_insert`) and the same search with the dense mask, one insert
     batch and one dynamic search; `rng_round` on the built pool and with its ids
     folded into L2-resident rows; the static search with a larger visited
     table and with the dense one, and the share of true 10-NN the built
     pools hold.

Each path (4, 3b, 4b, 4c, 4d's filtered and layout paths, 4e, 4f, 4g, 4h's
three workers and its CLI runs, 4i, 4j and 4l: the datastore's build, one
source-filtered retrieval and the generation; 4k's two small datastores;
4n's GRNND cells)
runs with the
launch counts set to 0 just before it and read just after; every kernel it
runs must have launched. Then one JSON line {"kernels": [...]} and, last,
{"ok": true, "device": ...}. Any failure raises and the exit code is
non-zero; without a card the script exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import importlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

# phase 4l's bitwise resume runs under torch.use_deterministic_algorithms,
# whose cuBLAS calls need this set before the first of them
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import checkpoint as CKPT  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_arch, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig, truncate_units  # noqa: E402
from repro_torch.configs.grnnd_paper import SIFT1M  # noqa: E402
from repro_torch.core import (  # noqa: E402
    Draws,
    Pool,
    DynamicConfig,
    DynamicIndex,
    brute_force_knn,
    build_graph,
    distance_excess,
    encode,
    encode_labels,
    filtered_brute_force,
    filtered_recall_at_k,
    init_random,
    optimize,
    overfetch_ef,
    pool_excess,
    predicate_fraction,
    random_query_filters,
    recall_at_k,
    search,
    update_round,
)
from repro_torch.core import corpus_shard as CS  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core.grnnd import GRNNDConfig  # noqa: E402
from repro_torch.core.labels import pack_ids  # noqa: E402
from repro_torch.core.pools import stage_request_matrix  # noqa: E402
from repro_torch.core.search import _table_insert, default_visited_cap  # noqa: E402
from repro_torch.data import pipeline as PIPE  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.synthetic import token_stream  # noqa: E402
from repro_torch.distributed import compression as COMP  # noqa: E402
from repro_torch.distributed import fault_tolerance as FT  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed.hints import use_hints  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.gather_l2 import gather_sqdist  # noqa: E402
from repro_torch.kernels.pairwise_l2 import pairwise_sqdist, rowwise_sqdist  # noqa: E402
from repro_torch.kernels.rng_round import rng_round  # noqa: E402
from repro_torch.kernels.search_expand import search_expand  # noqa: E402
from repro_torch.kernels.topr_merge import topr_merge  # noqa: E402
from repro_torch.kernels.visited_insert import visited_insert  # noqa: E402
from repro_torch.launch import _group  # noqa: E402
from repro_torch.launch import dryrun as DRY  # noqa: E402
from repro_torch.launch import specs as DR_SPEC  # noqa: E402
from repro_torch.launch import build_index as build_cli  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    PEAK_FLOPS_BF16,
    make_debug_mesh,
    make_production_mesh,
)
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import transformer as LM  # noqa: E402
from repro_torch.retrieval import knn_lm as KNN  # noqa: E402
from repro_torch.serve import ann_engine as AE  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train import optimizer as OPT  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

# the modules (the package exports functions under the same names)
search_mod = importlib.import_module("repro_torch.core.search")
grnnd_mod = importlib.import_module("repro_torch.core.grnnd")

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12  # H100 SXM fp32, outside the tensor cores
SEED = 0
N_PARITY, Q_PARITY = 100_000, 1_000
EF_MAIN = (64, 128)
# recall@10 floors of the n = 1M main path: they catch a broken graph and
# rank nothing (PERF.md gives the measured values beside them)
RECALL_FLOOR = {64: 0.60, 128: 0.75}
# fp32 tolerances: other summation orders than the plain versions (the
# bf16 / int8 dequant is bitwise the plain version's, so the same hold)
RTOL, ATOL = 1e-5, 1e-4
PAIRWISE_REL = 1e-5  # of |x|^2 + |y|^2 (norm-decomposition cancellation)
# the dynamic phase (fig10's protocol at SIFT1M's shape)
DYN_BASE, DYN_BATCH, DYN_DELETE, DYN_COMPACT_Q = 900_000, 10_000, 100_000, 1_000
DYN_CFG = DynamicConfig(
    precision="int8", seed_k=12, seed_ef=64, refine_rounds=2, pairs_per_vertex=48
)
DYN_RECALL_FLOOR = 0.50  # the static fp32 graph reads 0.638 here
# the kernels each path must launch (launch-count names, kernels/_build.py)
MAIN_KERNELS = (
    "rng_round", "topr_merge", "topr_merge/flags", "search_expand", "rowwise_sqdist",
    "pairwise_sqdist", "visited_insert",
)
DYN_KERNELS = (
    "gather_sqdist/int8",
    "rng_round/int8",
    "search_expand/int8+valid",
    "pairwise_sqdist/int8",
    "topr_merge",
    "rowwise_sqdist",
    "visited_insert",
)
BF16_KERNELS = (
    "gather_sqdist/bf16",
    "rng_round/bf16",
    "search_expand/bf16+valid",
    "pairwise_sqdist/bf16",
    "visited_insert",
)
# filtered search (4d): fig12's synthetic workload at SIFT1M's shape
N_LABELS, SELECTIVITIES = 100, (0.5, 0.1, 0.01)
# filtered recall@10 floors: they catch a broken predicate or result heap and
# rank nothing. Grounds: the unfiltered graph reads 0.638 at ef 64 on this
# synthetic corpus (fig12's 0.90 is at small n on its own data); a filter
# searched at the over-fetched ef should not fall far below that at
# s = 0.5 / 0.1, and at s = 0.01 only ~10,000 rows are allowed, so the beam
# sees a few hundred of them.
FILTERED_RECALL_FLOOR = {0.5: 0.40, 0.1: 0.40, 0.01: 0.10}
LAYOUT_Q = 1_000  # dense-mask queries of the layout check (1 GB of mask)
FILTERED_KERNELS = (
    "search_expand+filter", "topr_merge", "rowwise_sqdist", "pairwise_sqdist", "visited_insert"
)
LAYOUT_KERNELS = FILTERED_KERNELS + ("search_expand",)
TIERED_CFG = DYN_CFG._replace(tier="host", layout="bfs")
TIERED_KERNELS = (
    "search_expand/int8+valid+filter",
    "search_expand/int8+valid",
    "gather_sqdist/int8",
    "rng_round/int8",
    "pairwise_sqdist/int8",
    "topr_merge",
    "rowwise_sqdist",
    "visited_insert",
)
# the sorted-order ablation (3b): recall@10 floors at ef 64, written before
# the first card run; they catch a broken graph and rank nothing (an
# ascending build keeps few neighbors a vertex, ~8 of 48 at n = 20,000)
SORTED_FLOOR = {"ascending": 0.20, "descending": 0.30}
SORTED_KERNELS = (
    "topr_merge", "rowwise_sqdist", "pairwise_sqdist", "search_expand", "visited_insert"
)
# corpus sharding (4f): fig13's full-scale protocol at SIFT1M's shape
CORPUS_SHARDS, MERGE_ROUNDS, CROSS = 4, 5, 8
# recall@10 floor of the sharded build through the sharded search at ef 64,
# written before the first card run: under the replicated build's 0.638,
# as its cross-partition edges come only from 5 merge rounds
SHARDED_BUILD_FLOOR = 0.40
CORPUS_KERNELS = (
    "gather_sqdist", "rng_round", "topr_merge", "search_expand", "search_expand+filter",
    "search_expand/int8+valid", "rowwise_sqdist", "pairwise_sqdist", "visited_insert",
)
# torch.distributed at world size 1 (4g), at phase 3's n
NCCL_KERNELS = (
    "rng_round", "topr_merge", "search_expand", "rowwise_sqdist", "pairwise_sqdist",
    "visited_insert", "gather_sqdist/int8", "search_expand/int8+valid",
)
NCCL_RECALL_GAP = 0.02
# serving (4h): fig14's full-scale menu (`benchmarks/fig14_serving.py:79-89`)
# over phase 4's queries, the open-loop replay at 0.7 x the closed-loop
# capacity (`launch/serve.py:428`); the admission bound holds a whole
# closed-loop trace, so the capacity probe sheds nothing. The request counts
# (static 2,500 of phase 4's queries, dynamic and sharded 512) are cut from
# fig14's 10,000 / 2,048 / 2,048 to keep the script, phase 4l's training
# included, near half its time limit
SERVE_CFG = dict(max_batch=32, ef_menu=(32, 64), max_pending=16_384)
SERVE_K, SERVE_EF, SERVE_LOAD = (5, 10), (32, 64), 0.7
SERVE_STATIC_Q = 2_500
SERVE_DYN_Q, SERVE_CHURN, SERVE_CHURN_EVERY = 512, 16, 32  # `launch/serve.py:362-385`
SERVE_SHARD_Q, SERVE_Q1 = 512, 64
SERVE_RECALL_FLOOR = 0.45  # recall@k of the unfiltered requests, static and sharded
SERVE_KERNELS = {
    "static": (
        "topr_merge", "search_expand", "search_expand+filter", "rowwise_sqdist",
        "pairwise_sqdist", "visited_insert",
    ),
    "dynamic": (
        "rng_round/int8", "search_expand/int8+valid", "topr_merge", "rowwise_sqdist",
        "visited_insert",
    ),
    "sharded": ("search_expand", "topr_merge/flags", "rowwise_sqdist", "visited_insert"),
    # the CLI's build_index of the sift-small index
    "build": (
        "rng_round", "topr_merge", "search_expand", "rowwise_sqdist", "pairwise_sqdist",
        "visited_insert",
    ),
}
# the serving CLI's runs on a sift-small index (n = 20,000), each with
# `--device cuda`, and the kernels each launches besides SERVE_CLI_EVERY
# (the entry distance, the beam merge, the brute-force recall); the stats
# line of every run must parse
SERVE_CLI_EVERY = ("topr_merge/flags", "rowwise_sqdist", "pairwise_sqdist")
SERVE_CLI = (
    ("static", ["--visited", "hashed"], ("search_expand", "visited_insert")),
    ("filtered", ["--filter-labels", "100", "--selectivity", "0.1"], ("search_expand+filter",)),
    ("int8-host", ["--precision", "int8", "--tier", "host"],
     ("search_expand/int8", "pairwise_sqdist/int8")),
    ("layout", ["--optimize-layout", "bfs"], ("search_expand",)),
    ("corpus", ["--corpus-shards", "4"], ("search_expand",)),
    ("mutable", ["--mutable", "--churn", "64", "--precision", "int8"],
     ("gather_sqdist/int8", "rng_round/int8", "search_expand/int8+valid", "pairwise_sqdist/int8")),
    ("engine", ["--engine", "--visited", "hashed", "--mix-ef", "32,64"],
     ("search_expand", "visited_insert")),
    ("shards", ["--shards", "1"], ("search_expand",)),
)


@dataclasses.dataclass(frozen=True)
class KnnSpec:
    """One kNN-LM phase: the model at full width (random weights of
    `dtype`, bf16 activations), its harvest (`seqs` + KNN_HELD_SEQS Zipf
    streams of KNN_SEQ_LEN tokens, `chunk` sequences a forward) and the
    seed offset of its draws. `full` adds what 4i holds at D = 1152 alone:
    builds of 2^18 pairs at two seeds, the witness subset, the fp32
    datastore against the array-backed path, engine routing, and the fp32
    kernel rows. `label` names its log lines, launch counts and rows.
    `rows` measures phase 2's rows at the model's width; `floors` reads
    recall@10 at ef 32 and the memorization share against KNN_FLOORS (4l,
    on trained states)."""

    label: str
    arch: str
    seqs: int
    chunk: int
    dtype: torch.dtype
    seed: int
    full: bool
    rows: bool = True
    floors: bool = False


# kNN-LM (4i): gemma3-1b at full width, fp32 master weights; 2,048 sequences
# of 512 Zipf tokens harvested (1,046,528 stored pairs at D = 1152), indexed
# at int8 traversal + fp32 rescore with the hashed visited set.
# (4j): deepseek-moe-16b at full width in bf16 (33.8 GB: fp32 would leave no
# room for the datastore), 1,024 sequences, 64 a forward (T = 32,768 tokens:
# capacity 3,848 an expert, a 1.0 GB bf16 expert buffer): 523,264 pairs at
# D = 2048
KNN_HELD_SEQS, KNN_SEQ_LEN = 3, 512
KNN_4I = KnnSpec("knn", "gemma3-1b", 2048, 128, torch.float32, 40, True)
KNN_4J = KnnSpec("knn-moe", "deepseek-moe-16b", 1024, 64, torch.bfloat16, 50, False)
# (4l): 4i's datastore over the states of gemma3-1b as phase 4l trained it,
# fresh sequences (another seed), 4i's key count; its rows are 4i's
KNN_4L = KnnSpec("knn-trained", "gemma3-1b", 2048, 128, torch.float32, 90, False, rows=False,
                 floors=True)
# the floors of recall@10 at ef 32 on the held-out states and of the
# memorization share (stored keys as queries: the vote's argmax is the
# stored token), read on trained states; an unmet floor is printed as
# unmet, not raised: `token_stream` draws each position independently, so
# training can learn little beyond the unigram
KNN_FLOORS = {"recall@10": 0.40, "memorization": 0.90}
KNN_MIN_POS = 16  # held-out and memorization states: few identical prefixes here
KNN_SOURCES, KNN_K, KNN_EF, KNN_LAM = 4, 8, 32, 0.25
KNN_HELD, KNN_MEMO, KNN_ROUTED, KNN_FP32_N = 1_000, 4_096, 256, 1 << 18
KNN_PROMPTS, KNN_PROMPT_LEN, KNN_NEW, KNN_INSERT_EVERY = 32, 128, 64, 8
# no floor on recall by ids, nor on stored keys retrieving their own token,
# in 4i (4l reads them on trained weights, KNN_FLOORS): a randomly initialised
# model's states lie near-isotropic on the sphere of radius sqrt(1152),
# where neither the GRNND build nor a greedy walk finds many true neighbors
# (recall@10 ~0.014 at ef 32 here; PERF.md, the kNN-LM findings). What the
# phase holds instead is the distance excess (`distance_excess`: 0 at the
# true neighbors, ~1 at random rows) of the search and of 2^18-pair builds
# through the kernels, within KNN_EXCESS_GAP of the plain versions' on the
# same inputs and draws, and KNN_CONTROL_GAPS gaps under a random graph's
# search and random pools; and, where a stored key's own row is retrieved,
# the vote picking its token. The gap is 2.5x the widest spread of six
# sound 2^18-pair builds (kernels and plain versions at three seeds: 0.0039
# in pool excess, 0.0024 in search excess; PERF.md, the kNN-LM findings)
KNN_RECALL_EFS, KNN_OWN_FLOOR = (32, 128, 512), 0.99
KNN_EXCESS_GAP, KNN_CONTROL_GAPS = 0.01, 5
KNN_BUILD_SEEDS = (44, 45)  # 4i: each built through the kernels and the plain versions
# the witness subset: 2^14 stored keys, 256 held-out states and 1,024 sampled
# vertices, built and searched here through the kernels and the plain
# versions at each seed;
# `--knn-states PATH` saves them (bf16, as harvested) for
# tests/_knn_witness.py, which runs the JAX reference on them on the CPU
KNN_WIT_N, KNN_WIT_Q, KNN_WIT_V, KNN_WIT_SEEDS = 1 << 14, 256, 1024, (0, 1, 2)
KNN_KERNELS = (
    "rng_round", "rng_round/int8", "topr_merge", "search_expand/int8+valid",
    "search_expand/int8+valid+filter", "rowwise_sqdist", "pairwise_sqdist/int8",
    "gather_sqdist/int8", "visited_insert",
)
# the kernels of one streaming insert and one decode step's retrieval
KNN_PLAIN = (
    "search_expand/int8+valid", "topr_merge", "rowwise_sqdist", "visited_insert",
    "rng_round/int8", "pairwise_sqdist/int8",
)
ROW_PATH = {**dict.fromkeys(MAIN_KERNELS, "main"), **dict.fromkeys(BF16_KERNELS, "bf16")}
ROW_PATH.update(dict.fromkeys(DYN_KERNELS[:4], "dynamic"))
ROW_PATH.update({"search_expand+filter": "filtered", "search_expand/int8+valid+filter": "tiered"})
# the beam merges at the search shapes: rows that share the `topr_merge`
# launch counter (their rows say so under "launches_of")
BEAM_MERGES = ((64, "main"), (128, "main"), (400, "filtered"), (512, "filtered"))  # (ef, path), W = ef + R
ROW_PATH.update({f"topr_merge[W={ef + SIFT1M.build.r}]": path for ef, path in BEAM_MERGES})
# the first of them again as the search launches it, carrying the expanded flags
ROW_PATH[f"topr_merge/flags[W={BEAM_MERGES[0][0] + SIFT1M.build.r}]"] = "main"
ROW_PATH["pairwise_sqdist[M=1]"] = "main"  # the medoid's shape; shares the counter
# the corpus path's shapes of B6 (fp32 merge pairs) and B3 (one shard's step)
ROW_PATH.update({"gather_sqdist[merge]": "corpus", "search_expand[shard]": "corpus"})
# the hashed visited insert on the inserts of real searches at the main
# path's ef 64 / 128 and the filtered path's ef 512 (tables of 512, 1024 and
# 4096 slots): rows that share the `visited_insert` counter
INSERT_EFS = {64: "main", 128: "main", 512: "filtered"}
ROW_PATH.update(
    {f"visited_insert[H={default_visited_cap(ef)}]": path for ef, path in INSERT_EFS.items()}
)


def knn_row_names(spec: KnnSpec) -> list[str]:
    """Phase 2's rows at a kNN-LM phase's shapes, made in that phase."""
    tag = spec.label
    names = [
        f"rng_round[{tag}]", f"rng_round/int8[{tag}]", f"gather_sqdist/int8[{tag}]",
        f"rowwise_sqdist[{tag}]", f"pairwise_sqdist/int8[{tag},M=1]", f"pairwise_sqdist[{tag},truth]",
    ]
    names += [f"search_expand/int8+valid[{tag},Q={q}]" for q in (KNN_PROMPTS, KNN_HELD)]
    if spec.full:
        names += [f"gather_sqdist[{tag}]"]
        names += [f"search_expand+valid[{tag},Q={q}]" for q in (KNN_PROMPTS, KNN_HELD)]
    else:  # B1's direct reads beside its staged rows, where both run
        names += [f"rng_round+direct[{tag}]"]
    return names


for _spec in (KNN_4I, KNN_4J):
    ROW_PATH.update(dict.fromkeys(knn_row_names(_spec), _spec.label))

# 4k: the other families at full width from bf16 random weights, one on the
# card at a time (qwen3-moe cut to 4 of its 94 layers: 470 GB in bf16;
# gemma3-27b whole, 54 GB in bf16), 8
# prompts x 128 tokens (internvl2: plus 256 patch embeddings of width 1024;
# musicgen: 4 codebooks), 32 greedy steps. zamba2-7b's and qwen3-moe's
# states (D = 3584, 4096) also fill a small datastore (16 sequences of 512)
# whose fp32 build takes B1's direct-read path
FAMILIES = (
    ("mamba2-130m", None), ("zamba2-7b", None), ("musicgen-large", None),
    ("internvl2-2b", None), ("qwen3-moe-235b-a22b", 4), ("gemma2-2b", None),
    ("h2o-danube-1.8b", None), ("gemma3-27b", None),
)
FAM_PROMPTS, FAM_PROMPT_LEN, FAM_NEW = 8, 128, 32
FAM_TOL = 5e-3  # decode against the forward's last position (the reference's test)
FAM_DS = {"zamba2-7b": "knn-zamba2", "qwen3-moe-235b-a22b": "knn-qwen3"}
FAM_DS_SEQS = 16
FAM_DS_KERNELS = ("rng_round+direct", "rng_round/int8", "topr_merge", "search_expand/int8+valid",
                  "rowwise_sqdist", "pairwise_sqdist/int8", "gather_sqdist/int8",
                  "visited_insert")
# B1's direct-read rows at those widths, C = N = 2^17, R = P = 24 (fp32 rows
# past shared memory); their launches are the small datastores' builds
DIRECT_C, DIRECT_WIDTHS = 1 << 17, {3584: "knn-zamba2", 4096: "knn-qwen3"}
ROW_PATH.update({f"rng_round+direct[D={d}]": label for d, label in DIRECT_WIDTHS.items()})
# (c) the chunked SSD scan (fp32) against the recurrence (fp64) at zamba2's
# shapes
SSD_SHAPE, SSD_CHUNK, SSD_TOL = (2, 512, 112, 64, 64), 128, 1e-4
# (d) the MoE block at deepseek-moe-16b's shapes against a per-token loop
# (64 tokens, capacity 16: no drops), fp32 activations over bf16 weights;
# the reference's own tolerance for that comparison
MOE_LOOP_T, MOE_LOOP_TOL = 64, 2e-3

# 4l: training. gemma3-1b at full width (26 layers, d_model 1152, vocab
# 262,144) from `init_params(seed=0)` through `launch.train.train`: fp32
# master weights, bf16 activations, remat "full", CE chunks of 512, batch
# 8 x 512 tokens of `pipeline` batches, AdamW at the CLI's lr (warmup a
# tenth of the steps, cosine to the end); TRAIN_STEPS fits ~90 s (0.696 s
# a step on an H100 80GB HBM3 at 700 W: the loss plateaus at ~9.1, the
# unigram, from step ~20). The last
# logged loss must lie TRAIN_DROP below the first (the reference's
# `test_loss_decreases_tiny_lm` margin)
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "gemma3-1b", 120, 8, 512
TRAIN_LR, TRAIN_LOG_EVERY, TRAIN_DROP = 3e-4, 10, 0.3
# the bitwise resume: gemma3-1b at full width cut to one pattern unit (8
# layers), RESUME_K steps, save, restore into a fresh state, RESUME_M more,
# against RESUME_K + RESUME_M uninterrupted steps, under
# torch.use_deterministic_algorithms
RESUME_UNITS, RESUME_K, RESUME_M, RESUME_BATCH, RESUME_SEQ = 1, 3, 3, 4, 256
# one training step a family at reduced() width, fp32 activations, on the
# card and on the CPU port from the same parameters and batch: the loss
# within STEP_LOSS_TOL, each gradient leaf within STEP_GRAD_TOL of the
# CPU leaf's largest magnitude (10x the tolerances the CPU tests hold the
# port to against JAX: two devices' summation orders and transcendentals)
STEP_BATCH, STEP_SEQ, STEP_LOSS_TOL, STEP_GRAD_TOL = 2, 64, 1e-4, 1e-3

# 4m: the multi-rank training pieces at world size 1 on NCCL. Compression:
# one gradient of 4l's trained gemma3-1b (batch TRAIN_BATCH x TRAIN_SEQ)
# through `compressed_psum_mean`; q and the scales of DIST_LEAVES bitwise
# the CPU port's. The compressed train step and the supervisor run 4l's
# resume model (RESUME_UNITS, RESUME_BATCH x RESUME_SEQ) under deterministic
# algorithms: DIST_K compressed steps bitwise DIST_K plain steps on the
# quantized gradients, then DIST_STEPS in all; FT_STEPS supervised steps
# (FT_HOSTS simulated hosts, a checkpoint every FT_SAVE_EVERY, one host lost
# before step FT_KILL_AT) bitwise FT_STEPS straight ones
DIST_LEAVES = ("embed", "layers.0.attn.wq", "layers.25.mlp.wo", "final_norm")
DIST_K, DIST_STEPS = 3, 20
FT_HOSTS, FT_STEPS, FT_SAVE_EVERY, FT_KILL_AT = 4, 10, 5, 7
# the expert-parallel MoE layer: deepseek-moe-16b's (d_model 2048, 64 routed
# experts top-6, 2 shared, d_expert 1408) at capacity factor 16 (no drops),
# EP_BATCH x EP_SEQ tokens in fp32, fp32 weights, under
# `use_hints(make_debug_mesh((1, 1)))` against the dense path: the output
# within EP_OUT_TOL of the largest output magnitude, each gradient of
# sum(y^2) within EP_GRAD_TOL (of the leaf's largest magnitude where that
# exceeds 1), the reference test's tolerances
EP_ARCH, EP_BATCH, EP_SEQ, EP_CAPACITY, EP_OUT_TOL, EP_GRAD_TOL = (
    "deepseek-moe-16b", 8, 512, 16.0, 1e-5, 1e-3)

# 4n: the production-mesh dry-run. The GRNND cells (one rank's a2a build
# round, real tensors on the card) of each shape over fake groups of each
# world (the production meshes' 256 and 512 ranks, and 16 and 32 under
# REPRO_TORCH_MESH_OVERRIDE "4,4" / "2,4,4"); 4l's train step traced on
# meta at a (1, 1) mesh against one real step; the production cells on the
# 16 x 16 fake group, one a policy, the fsdp one with its cost probes, and
# one long-context decode cell
DRY_WORLDS = ((256, None), (512, None), (16, "4,4"), (32, "2,4,4"))  # (ranks, override)
# (arch, shape, whole, probes): the cells whose whole-depth trace takes
# 45-60 s on an H100 machine's host (mamba2-130m's 24 layers of scan chunks,
# gemma3-27b's 62 layers, qwen3-moe's 94) are cut to their 1- and 2-unit
# probes, extrapolated (`dryrun.probe_cost`), to keep 4n near 60 s;
# `tools/dryrun_sweep.sh` traces them whole. gemma2-2b's train cell is
# traced whole and by its probes, which must agree
DRY_CELLS = (("mamba2-130m", "train_4k", False, True), ("gemma2-2b", "train_4k", True, True),
             ("gemma3-27b", "train_4k", False, True),
             ("qwen3-moe-235b-a22b", "train_4k", False, True),
             ("gemma2-2b", "long_500k", True, False))
ROW_PATH.update({f"{k}[grnnd,d={spec['d']},S={w}]": "dryrun" for k in ("rng_round", "topr_merge")
                 for spec in DR_SPEC.GRNND_SHAPES.values() for w, _ in DRY_WORLDS})


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean milliseconds of device (kernel) time per call, from
    torch.profiler: unlike `cuda_ms` it leaves out the gaps in which the
    card waits for the host to launch the next call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(_device_us(e) for e in prof.key_averages()) / 1e3 / reps


def bound(nbytes: float, ops_fp32: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops_fp32 / PEAK_FP32_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def gathered_sqdist(x, ni, nj, scale=None, offset=None, chunk: int = 1 << 22) -> torch.Tensor:
    """B6's function as the composed PyTorch expression
    `(x[ni] - x[nj]).square().sum(-1)` over dequantized rows, in chunks of
    `chunk` pairs (one shot at M = 43.2M would hold ~66 GB of gathered
    rows): the library yardstick of the `gather_sqdist` rows."""
    out = torch.empty(ni.shape, dtype=torch.float32, device=ni.device)
    for lo in range(0, ni.shape[0], chunk):
        a, b = x[ni[lo : lo + chunk].long()], x[nj[lo : lo + chunk].long()]
        if scale is not None:
            a, b = a.float() * scale + offset, b.float() * scale + offset
        out[lo : lo + chunk] = (a.float() - b.float()).square().sum(-1)
    return out


def unique_rows(ids: torch.Tensor) -> int:
    return int(torch.unique(ids[ids >= 0]).numel())


def close(got, want, what: str) -> float:
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} values outside rtol {RTOL} atol {ATOL}")
    return float(err.max()) if err.numel() else 0.0


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_device() -> str:
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    ).stdout.strip()
    log(smi.splitlines()[0])
    log(
        f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}"
    )
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions stay full fp32
    torch.backends.cudnn.allow_tf32 = False
    secs = _build.build_all()
    for name in _build.SOURCES:
        regs = [ln.strip() for ln in _build.ptxas_report(name).splitlines() if "registers" in ln]
        log(f"[build] {name}.cu {secs[name]:.1f}s; ptxas: {' | '.join(regs)}")
    log(f"[device] done in {time.perf_counter() - t0:.1f}s")
    return smi.splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def kernel_row(
    rows, name, source, replaces, kernel, plain, check, nbytes, nops, library, reps,
    launches_of=None, yardstick=None, calls=1,
):
    """Hold `kernel` against `plain` with `check`, time both (and `library`,
    where one PyTorch call computes the same function), and append the row.
    A call of `kernel` that makes `calls` launches (`nbytes` and `nops`
    counting all of them) gives its times and bound a launch."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err, extra = check(got, want)
    del got, want
    ms = cuda_ms(kernel, reps) / calls
    dev_ms = device_ms(kernel, reps) / calls
    plain_ms = cuda_ms(plain, max(1, reps // 3)) / calls
    lib_ms = cuda_ms(library, reps) / calls if library is not None else None
    b_ms, b_by = bound(nbytes / calls, nops / calls)
    rows.append(
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": 0,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": lib_ms,
            **({"launches_of": launches_of} if launches_of else {}),
        }
    )
    lib = "none" if lib_ms is None else f"{lib_ms:.3f} ms"
    if yardstick is not None:  # (label, fn): timed beside the row, never called by the port
        extra += f"; {yardstick[0]} {cuda_ms(yardstick[1], reps):.3f} ms"
    log(
        f"[kernels] {name}: {ms:.3f} ms, device {dev_ms:.3f} ms (plain {plain_ms:.3f} ms, "
        f"library {lib}, bound {b_ms:.3f} ms by {b_by}); max abs err {err:.3g}{extra}"
    )


def check_rng_round(got, want, dists, si, sj) -> tuple[float, int]:
    """dij within tolerance; src equal; dst / kill equal except where the hit
    test's dij sits within the tolerance of its threshold. Returns
    (max abs dij error, mismatched pairs at near-ties)."""
    err = close(got[2], want[2], "rng_round dij")
    if not torch.equal(got[1], want[1]):
        raise AssertionError("rng_round src differs")
    thr = torch.maximum(dists.gather(1, si.long()), dists.gather(1, sj.long()))
    near = (want[2] - thr).abs() <= ATOL + RTOL * thr.abs()
    dst_bad = got[0] != want[0]
    if bool((dst_bad & ~near).any()):
        raise AssertionError("rng_round dst differs away from a near-tie")
    if bool(((got[3] != want[3]).any(1) & ~near.any(1)).any()):
        raise AssertionError("rng_round kill differs in a row without a near-tie")
    return err, int(dst_bad.sum())


def phase_kernels(x, queries, draws, cfg) -> list[dict]:
    t0 = time.perf_counter()
    n, d = x.shape
    r, p = cfg.r, cfg.pairs_per_vertex
    dev = x.device
    # a pool as the build holds it after one round, and that round's inputs
    pool = update_round(x, init_random(draws, x, cfg.s, r), draws, cfg, 0, 0)
    si, sj = (a.to(dev) for a in draws.slot_pairs(0, 1, None, n, r, p))
    round_out = rng_round(x, pool.ids, pool.dists, si, sj)
    staged_i, staged_d = stage_request_matrix(*round_out[:3], n, cfg.cap)
    merge_ids = torch.cat([torch.where(round_out[3], -1, pool.ids), staged_i], 1)
    merge_d = torch.cat([torch.where(round_out[3], torch.inf, pool.dists), staged_d], 1)
    # one beam step of the search at ef = 64: Q rows of R neighbors, and a
    # 512-slot visited table per query that already holds R ids
    q = queries.shape[0]
    g = torch.Generator(dev).manual_seed(SEED + 5)
    gm = torch.Generator(dev).manual_seed(SEED + 7)  # the beam-merge rows' inputs
    sel = torch.randint(0, n, (q,), generator=g, device=dev)
    nbrs = pool.ids[sel].contiguous()
    table = torch.full((q, 512), -1, dtype=torch.int32, device=dev)
    _table_insert(table, pool.ids[torch.randint(0, n, (q,), generator=g, device=dev)])
    # init distances: one block of the owner-distance pass
    blk = 1 << 16
    owners = x[:blk].repeat_interleave(cfg.s, 0)
    nv = x[pool.ids[:blk, : cfg.s].clamp_min(0).long()].reshape(-1, d)
    gt_q = queries[:1024].contiguous()
    torch.cuda.synchronize()

    rows = []
    measure = functools.partial(kernel_row, rows)

    def rng_check(got, want):
        err, ties = check_rng_round(got, want, pool.dists, si, sj)
        return err, f"; {ties} dst mismatches at near-ties"

    c = n
    measure(
        "rng_round",
        "src/repro_torch/kernels/csrc/rng_round.cu",
        "src/repro/kernels/rng_round.py:124",
        lambda: rng_round(x, pool.ids, pool.dists, si, sj),
        lambda: ref.rng_round_ref(x, pool.ids, pool.dists, si, sj),
        rng_check,
        unique_rows(pool.ids) * d * 4 + c * r * 9 + c * p * 20,
        3 * c * p * d,
        None,
        10,
    )

    def merge_check(got, want):
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError("topr_merge differs from its plain version")
        return 0.0, "; ids and dists equal"

    def flags_check(got, want):
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("topr_merge/flags differs from its plain version")
        return 0.0, "; ids, dists and flags equal"

    b, w = merge_ids.shape
    measure(
        "topr_merge",
        "src/repro_torch/kernels/csrc/topr_merge.cu",
        "src/repro/kernels/topr_merge.py:58",
        lambda: topr_merge(merge_ids, merge_d, r),
        lambda: ref.topr_merge_ref(merge_ids, merge_d, r),
        merge_check,
        b * w * 8 + b * r * 8,
        b * w * math.log2(w),  # the comparisons of a sort per row
        None,
        10,
    )

    # the beam merges of the search paths (W = ef + R): a sorted beam of ef
    # candidates, then the R neighbors of one expansion, a quarter of them
    # repeats of beam ids and a third stale (-1, +inf)
    for ef, _ in BEAM_MERGES:
        bi = torch.randint(0, n, (q, ef), generator=gm, device=dev, dtype=torch.int32)
        bd = torch.rand((q, ef), generator=gm, device=dev).sort(1).values
        ei = torch.randint(0, n, (q, r), generator=gm, device=dev, dtype=torch.int32)
        rep = torch.rand((q, r), generator=gm, device=dev) < 0.25
        ei = torch.where(
            rep, bi.gather(1, torch.randint(0, ef, (q, r), generator=gm, device=dev)), ei
        )
        ei = torch.where(torch.rand((q, r), generator=gm, device=dev) < 0.3, -1, ei)
        ed = torch.where(ei >= 0, torch.rand((q, r), generator=gm, device=dev), torch.inf)
        mi, md = torch.cat([bi, ei], 1).contiguous(), torch.cat([bd, ed], 1).contiguous()
        wb = ef + r
        measure(
            f"topr_merge[W={wb}]",
            "src/repro_torch/kernels/csrc/topr_merge.cu",
            "src/repro/kernels/topr_merge.py:58",
            lambda mi=mi, md=md, ef=ef: topr_merge(mi, md, ef),
            lambda mi=mi, md=md, ef=ef: ref.topr_merge_ref(mi, md, ef),
            merge_check,
            q * wb * 8 + q * ef * 8,
            q * wb * math.log2(wb),
            None,
            20,
            launches_of="topr_merge",
        )
        if ef == BEAM_MERGES[0][0]:
            # the candidates' expanded flags (half set), carried through
            fl = torch.rand((q, ef), generator=gm, device=dev) < 0.5
            measure(
                f"topr_merge/flags[W={wb}]",
                "src/repro_torch/kernels/csrc/topr_merge.cu",
                "src/repro/kernels/topr_merge.py:58",
                lambda mi=mi, md=md, ef=ef, fl=fl: topr_merge(mi, md, ef, fl),
                lambda mi=mi, md=md, ef=ef, fl=fl: ref.topr_merge_ref(mi, md, ef, fl),
                flags_check,
                q * wb * 8 + q * ef * 8 + 2 * q * ef,  # and a flag byte in and out a slot
                q * wb * math.log2(wb),
                None,
                20,
                launches_of="topr_merge/flags",
            )
            del fl
        del bi, bd, ei, ed, mi, md

    def expand_check(got, want):
        if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])):
            raise AssertionError("search_expand ids / fresh differ from the plain version")
        live = want[0] >= 0
        return close(got[1][live], want[1][live], "search_expand dists"), ""

    live = int((nbrs >= 0).sum())
    measure(
        "search_expand",
        "src/repro_torch/kernels/csrc/search_expand.cu",
        "src/repro/kernels/search_expand.py:170",
        lambda: search_expand(x, queries, nbrs, table),
        lambda: ref.search_expand_ref(x, queries, nbrs, table),
        expand_check,
        unique_rows(nbrs) * d * 4 + q * d * 4 + q * r * 13 + min(q * 512, live * 8) * 4,
        3 * live * d,
        None,
        20,
    )

    m = owners.shape[0]
    measure(
        "rowwise_sqdist",
        "src/repro_torch/kernels/csrc/pairwise_l2.cu",
        "src/repro/kernels/pairwise_l2.py:155",
        lambda: rowwise_sqdist(owners, nv),
        lambda: ref.rowwise_sqdist_ref(owners, nv),
        lambda got, want: (close(got, want, "rowwise_sqdist"), ""),
        2 * m * d * 4 + m * 4,
        3 * m * d,
        lambda: ((owners - nv) ** 2).sum(-1),
        20,
    )

    def pairwise_check(got, want, xq=gt_q):
        scale = (xq * xq).sum(-1)[:, None] + (x * x).sum(-1)[None, :]
        err = (got - want).abs()
        if bool((err > PAIRWISE_REL * scale + 1e-6).any()):
            raise AssertionError("pairwise_sqdist outside its tolerance")
        return float(err.max()), ""

    mq = gt_q.shape[0]
    measure(
        "pairwise_sqdist",
        "src/repro_torch/kernels/csrc/pairwise_l2.cu",
        "src/repro/kernels/pairwise_l2.py:80",
        lambda: pairwise_sqdist(gt_q, x),
        lambda: ref.pairwise_sqdist_ref(gt_q, x),
        pairwise_check,
        (mq + n) * d * 4 + mq * n * 4,
        2 * mq * n * d,
        lambda: torch.cdist(gt_q, x).square(),
        5,
        # the fp32 GEMM yardstick (cuBLAS SGEMM, TF32 off): the x.y part alone
        yardstick=("SGEMM torch.mm(gt_q, x.T)", lambda: torch.mm(gt_q, x.T)),
    )
    # the medoid's call: the corpus centroid against every row (M = 1)
    cen = x.mean(0, keepdim=True)
    measure(
        "pairwise_sqdist[M=1]",
        "src/repro_torch/kernels/csrc/pairwise_l2.cu",
        "src/repro/kernels/pairwise_l2.py:80",
        lambda: pairwise_sqdist(cen, x),
        lambda: ref.pairwise_sqdist_ref(cen, x),
        lambda got, want: pairwise_check(got, want, cen),
        (1 + n) * d * 4 + n * 4,
        3 * n * d,
        lambda: torch.cdist(cen, x).square(),
        20,
        launches_of="pairwise_sqdist",
    )
    del cen

    # -- the storage variants and the tombstone mask, at the dynamic path's
    # shapes: the 43.2M-edge re-base of a 900,000-row build, the 130,000-row
    # frontier of a 10,000-vector insert batch (seed_k 12), a 10,000-query
    # beam step with ~10% tombstones, and the ground-truth block
    m6 = DYN_BASE * r
    owners = torch.arange(DYN_BASE, dtype=torch.int32, device=dev).repeat_interleave(r)
    nj = pool.ids[:DYN_BASE].clamp_min(0).reshape(-1).contiguous()
    c1 = DYN_BATCH * (1 + DYN_CFG.seed_k)
    fr = torch.randint(0, n, (c1,), generator=g, device=dev)
    f_ids, f_dists = pool.ids[fr].contiguous(), pool.dists[fr].contiguous()
    f_si = torch.randint(0, r, (c1, p), generator=g, device=dev, dtype=torch.int32)
    f_sj = torch.randint(0, r, (c1, p), generator=g, device=dev, dtype=torch.int32)
    valid = torch.rand((n,), generator=g, device=dev) > 0.1
    live_v = (nbrs >= 0) & valid[nbrs.clamp_min(0).long()]
    n_live_v = int(live_v.sum())
    for rung in ("int8", "bf16"):
        data, sc, of = encode(x, rung)
        size = data.element_size()
        dq = 4 * d if sc is not None else 0  # dequant operations per row, per pair
        sdo = 2 * d * 4 if sc is not None else 0  # the scale / offset bytes
        rows_m = unique_rows(torch.cat([owners, nj]))
        # the second bound, on the log line only: every neighbor row as
        # gathered, each owner row once, the indices and the output
        gathered = (m6 + unique_rows(owners)) * d * size + sdo + m6 * 12
        gathered_ms = gathered / PEAK_BYTES_PER_S * 1e3
        measure(
            f"gather_sqdist/{rung}",
            "src/repro_torch/kernels/csrc/gather_l2.cu",
            "src/repro/kernels/gather_l2.py:52",
            lambda: gather_sqdist(data, owners, nj, sc, of),
            lambda: ref.gather_sqdist_ref(data, owners, nj, sc, of),
            lambda got, want, g_ms=gathered_ms: (
                close(got, want, f"gather_sqdist/{rung}"), f"; gathered-rows bound {g_ms:.3f} ms"
            ),
            rows_m * d * size + sdo + m6 * 12,
            m6 * (3 * d + dq),
            lambda: gathered_sqdist(data, owners, nj, sc, of),
            5,
        )

        def rng_check_q(got, want):
            err, ties = check_rng_round(got, want, f_dists, f_si, f_sj)
            return err, f"; {ties} dst mismatches at near-ties"

        measure(
            f"rng_round/{rung}",
            "src/repro_torch/kernels/csrc/rng_round.cu",
            "src/repro/kernels/rng_round.py:124",
            lambda: rng_round(data, f_ids, f_dists, f_si, f_sj, sc, of),
            lambda: ref.rng_round_ref(data, f_ids, f_dists, f_si, f_sj, sc, of),
            rng_check_q,
            unique_rows(f_ids) * d * size + sdo + c1 * r * 9 + c1 * p * 20,
            3 * c1 * p * d + (c1 * r * dq // 2),
            None,
            20,
        )

        def expand_check_q(got, want):
            if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])):
                raise AssertionError(f"search_expand/{rung}+valid ids / fresh differ")
            ok = want[0] >= 0
            return close(got[1][ok], want[1][ok], f"search_expand/{rung}+valid dists"), ""

        probed = unique_rows(nbrs)
        measure(
            f"search_expand/{rung}+valid",
            "src/repro_torch/kernels/csrc/search_expand.cu",
            "src/repro/kernels/search_expand.py:170",
            lambda: search_expand(data, queries, nbrs, table, valid, sc, of),
            lambda: ref.search_expand_ref(data, queries, nbrs, table, valid, sc, of),
            expand_check_q,
            unique_rows(torch.where(live_v, nbrs, -1)) * d * size
            + sdo
            + probed
            + q * d * 4
            + q * r * 13
            + min(q * 512, live * 8) * 4,
            n_live_v * (3 * d + dq // 2),
            None,
            20,
        )

        def pairwise_check_q(got, want):
            y = ref.dequant_rows(data, sc, of)
            scale = (gt_q * gt_q).sum(-1)[:, None] + (y * y).sum(-1)[None, :]
            err = (got - want).abs()
            if bool((err > PAIRWISE_REL * scale + 1e-6).any()):
                raise AssertionError(f"pairwise_sqdist/{rung} outside its tolerance")
            return float(err.max()), ""

        measure(
            f"pairwise_sqdist/{rung}",
            "src/repro_torch/kernels/csrc/pairwise_l2.cu",
            "src/repro/kernels/pairwise_l2.py:80",
            lambda: pairwise_sqdist(gt_q, data, None, None, sc, of),
            lambda: ref.pairwise_sqdist_ref(gt_q, data, None, None, sc, of),
            pairwise_check_q,
            mq * d * 4 + n * d * size + sdo + mq * n * 4,
            2 * mq * n * d + n * dq // 2,
            lambda: torch.cdist(gt_q, ref.dequant_rows(data, sc, of)).square(),
            5,
        )
        del data, sc, of
        torch.cuda.empty_cache()

    # -- the label filter (B3's filter variant) at the filtered paths'
    # shapes: 100 labels (W = 4 words), predicates at selectivity 0.1
    vwords = pack_ids(torch.randint(0, N_LABELS, (n,), generator=g, device=dev), N_LABELS)
    fwords = random_query_filters(g, q, N_LABELS, 0.1)
    w = vwords.shape[1]
    data8, sc8, of8 = encode(x, "int8")
    for name, args, live_f in (
        ("search_expand+filter", (x, queries, nbrs, table, None, None, None), nbrs >= 0),
        ("search_expand/int8+valid+filter", (data8, queries, nbrs, table, valid, sc8, of8), live_v),
    ):
        size = args[0].element_size()

        def filter_check(got, want, args=args, name=name):
            if not all(torch.equal(got[i], want[i]) for i in (0, 2, 3)):
                raise AssertionError(f"{name} ids / fresh / allowed differ from the plain version")
            unfiltered = search_expand(*args)
            if not all(torch.equal(a, b) for a, b in zip(got[:3], unfiltered)):
                raise AssertionError(f"{name}: ids / dists / fresh not those of the unfiltered step")
            ok = want[0] >= 0
            err = close(got[1][ok], want[1][ok], f"{name} dists")
            return err, f"; allowed {float(got[3].float().mean()):.3f} of slots, route-through exact"

        n_live_f = int(live_f.sum())
        measure(
            name,
            "src/repro_torch/kernels/csrc/search_expand.cu",
            "src/repro/kernels/search_expand.py:170",
            lambda args=args: search_expand(*args, vwords, fwords),
            lambda args=args: ref.search_expand_ref(*args, vwords, fwords),
            filter_check,
            unique_rows(torch.where(live_f, nbrs, -1)) * (d * size + w * 4)
            + (2 * d * 4 if args[5] is not None else 0)
            + (unique_rows(nbrs) if args[4] is not None else 0)
            + q * d * 4
            + q * w * 4
            + q * r * 14
            + min(q * 512, live * 8) * 4,
            n_live_f * (3 * d + (2 * d if args[5] is not None else 0)) + n_live_f * w * 2,
            None,
            20,
        )
    del data8, sc8, of8, vwords, fwords
    torch.cuda.empty_cache()

    # -- the corpus path's shapes (4f): B6 at fp32 on a merge round's pairs
    # (every vertex in a run of 8 beside 8 candidates from the other shards,
    # drawn as `corpus_shard._cross_candidates` draws them), and B3 as one
    # shard of the sharded search runs it: its (n / S, D) slice, the
    # neighbors it does not own masked to -1, the (Q, 1) table of -1
    row0s, n_loc = CS.shard_bounds(n, CORPUS_SHARDS)
    raw = torch.randint(0, 2**31 - 1, (n, CROSS), generator=g, device=dev, dtype=torch.int32)
    cj = CS._cross_candidates(raw, n, n_loc).reshape(-1)
    ci = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(CROSS)
    m8 = ci.shape[0]
    gathered_ms = ((m8 + n) * d * 4 + m8 * 12) / PEAK_BYTES_PER_S * 1e3
    measure(
        "gather_sqdist[merge]",
        "src/repro_torch/kernels/csrc/gather_l2.cu",
        "src/repro/kernels/gather_l2.py:52",
        lambda: gather_sqdist(x, ci, cj),
        lambda: ref.gather_sqdist_ref(x, ci, cj),
        lambda got, want: (
            close(got, want, "gather_sqdist[merge]"),
            f"; gathered-rows bound {gathered_ms:.3f} ms",
        ),
        unique_rows(torch.cat([ci, cj])) * d * 4 + m8 * 12,
        m8 * 3 * d,
        lambda: gathered_sqdist(x, ci, cj),
        5,
        launches_of="gather_sqdist",
    )
    del raw, cj, ci
    k = 1
    x_sh = x[row0s[k] : row0s[k] + n_loc]
    owned, loc = CS._owner(nbrs, row0s[k], min(n_loc, n - row0s[k]), n_loc)
    nloc = torch.where(owned, loc, -1).to(torch.int32)
    dummy = torch.full((q, 1), -1, dtype=torch.int32, device=dev)
    live_s = int((nloc >= 0).sum())

    def shard_check(got, want):
        err, _ = expand_check(got, want)
        return err, f"; {1 - live_s / nloc.numel():.3f} of slots masked"

    measure(
        "search_expand[shard]",
        "src/repro_torch/kernels/csrc/search_expand.cu",
        "src/repro/kernels/search_expand.py:170",
        lambda: search_expand(x_sh, queries, nloc, dummy),
        lambda: ref.search_expand_ref(x_sh, queries, nloc, dummy),
        shard_check,
        unique_rows(nloc) * d * 4 + q * d * 4 + q * r * 13 + q * 4,
        3 * live_s * d,
        None,
        20,
        launches_of="search_expand",
    )
    del nloc, dummy
    log(f"[kernels] done in {time.perf_counter() - t0:.1f}s")
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_parity(dev, cfg):
    """Kernel-vs-plain parity of the fp32 build and of the int8 build with
    an fp32 rescore."""
    t0 = time.perf_counter()
    g = torch.Generator(dev).manual_seed(SEED + 10)
    x = synthetic.make_preset(g, "sift-like", N_PARITY)
    queries = synthetic.queries_from(g, x, Q_PARITY)
    truth = brute_force_knn(x, queries, 10, device=dev)
    kept = {}
    for rung in ("fp32", "int8"):
        data = x if rung == "fp32" else encode(x, rung)
        rescore = None if rung == "fp32" else x
        recalls = {}
        for name in ("auto", "ref"):
            with ops.backend(name):
                pool, build_s = timed(
                    lambda: build_graph(data, cfg, draws=Draws(SEED + 11, dev), device=dev)
                )
                res, search_s = timed(
                    lambda: search(
                        data,
                        pool.ids,
                        queries,
                        k=10,
                        ef=64,
                        visited="hashed",
                        rescore=rescore,
                        device=dev,
                    )
                )
            recalls[name] = recall_at_k(res.ids, truth)
            log(
                f"[parity] n={N_PARITY} {rung} backend={name}: build {build_s:.2f}s, "
                f"search {search_s:.2f}s, recall@10 {recalls[name]:.4f}"
            )
        gap = abs(recalls["auto"] - recalls["ref"])
        if gap > 0.01:
            raise AssertionError(f"{rung}: kernel and plain builds differ by {gap:.4f} recall@10")
        log(f"[parity] {rung}: |kernels - plain| = {gap:.4f} <= 0.01")
        kept[rung] = recalls["auto"]
    log(f"[parity] done in {time.perf_counter() - t0:.1f}s")
    return x, queries, truth, kept["fp32"]


def path_counts(label: str, counts: dict, needed, rows) -> None:
    """Fail unless every kernel of the path launched; give the rows of this
    path their launch counts."""
    log(f"[{label}] launches: { {k: v for k, v in sorted(counts.items()) if v} }")
    missing = [name for name in needed if counts.get(name, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {label} path: {missing}")
    for row in rows:
        if ROW_PATH[row["name"]] == label:
            row["launches"] = counts.get(row.get("launches_of", row["name"]), 0)


class Copies:
    """Fresh copies of an in-place kernel's operand, made before any timing:
    each call hands out the next one."""

    def __init__(self, t: torch.Tensor, n: int):
        self.copies, self.used = [t.clone() for _ in range(n)], 0

    def __call__(self) -> torch.Tensor:
        self.used += 1
        return self.copies[self.used - 1]


def record_inserts(x, graph_ids, queries, ef: int) -> list:
    """The (Q, R) ids of every visited insert of one hashed search at `ef`
    (the entry's, then one a step), recorded by a hook on `_table_insert`."""
    calls, real = [], search_mod._table_insert

    def hook(table, ids):
        calls.append(ids.contiguous().clone())
        return real(table, ids)

    search_mod._table_insert = hook
    try:
        search(x, graph_ids, queries, k=10, ef=ef, visited="hashed", device=x.device)
    finally:
        search_mod._table_insert = real
    return calls


def insert_rows(x, graph_ids, queries, rows, reps: int = 3) -> None:
    """The visited-insert rows, on the traffic of real searches: each row
    replays every insert that one hashed search of the phase-4 graph made at
    its ef (INSERT_EFS), from empty tables of `default_visited_cap(ef)`
    slots. The replay is held exactly against the column loop of
    `ref.visited_insert_ref` after every launch (and its end in the row's
    own check); times and bound are a launch's, the mean over the search."""
    t0 = time.perf_counter()
    dev = x.device
    q = queries.shape[0]
    for ef in INSERT_EFS:
        h = default_visited_cap(ef)
        calls = record_inserts(x, graph_ids, queries, ef)
        # the traffic, launch by launch: live (fresh) ids, the tables' fill
        # before the launch, the slots it writes, the distinct slots its
        # windows probe (the bytes it must move)
        got = torch.full((q, h), -1, dtype=torch.int32, device=dev)
        want = got.clone()
        qrows = torch.arange(q, device=dev)[:, None, None]
        live = written = probed = 0
        fill = []
        for t, ids in enumerate(calls):
            fresh = ids >= 0
            live += int(fresh.sum()) if t else 0  # the entry's insert is no step
            held = int((got >= 0).sum())
            fill.append(held / (q * h))
            pos = qrows * h + ref.visited_probe_positions(ids, h)
            probed += int(torch.unique(pos[fresh]).numel())
            visited_insert(got, ids)
            ref.visited_insert_ref(want, ids)
            if not torch.equal(got, want):
                raise AssertionError(f"visited_insert at H={h}: launch {t} differs from the loop")
            written += int((got >= 0).sum()) - held
        steps, r = len(calls) - 1, calls[-1].shape[1]
        traffic = (
            f"{steps} steps, {live / (steps * q):.2f} live ids a query a step of {r} "
            f"({live / (steps * q * r):.3f}), tables {sum(fill) / len(fill):.3f} full before a "
            f"launch on average and {float((got >= 0).float().mean()):.3f} at the end, "
            f"{written} slots written"
        )
        log(f"[kernels] visited_insert traffic at ef={ef}, H={h}: {traffic}")
        nbytes = sum(ids.numel() for ids in calls) * 4 + probed * 4 + written * 4
        del got, want
        empty = torch.full((q, h), -1, dtype=torch.int32, device=dev)
        copies = Copies(empty, 2 * (reps + 1) + max(1, reps // 3) + 3)

        def replay(insert, calls=calls):
            table = copies()
            for ids in calls:
                insert(table, ids)
            return table

        def check(got, want, h=h, n=len(calls)):
            if not torch.equal(got, want):
                raise AssertionError(f"visited_insert at H={h} differs from the column loop")
            return 0.0, f"; tables equal after each of {n} launches"

        kernel_row(
            rows,
            f"visited_insert[H={h}]",
            "src/repro_torch/kernels/csrc/visited_insert.cu",
            "src/repro/core/search.py:105",
            lambda: replay(visited_insert),
            lambda: replay(ref.visited_insert_ref),
            check,
            nbytes,
            0,
            None,
            reps,
            launches_of="visited_insert",
            calls=len(calls),
        )
        del calls, empty, copies
        torch.cuda.empty_cache()
    log(f"[kernels] visited_insert rows done in {time.perf_counter() - t0:.1f}s")


def phase_main(x, queries, cfg, rows):
    t0 = time.perf_counter()
    dev = x.device
    n, k = x.shape[0], 10
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    pool, build_s = timed(lambda: build_graph(x, cfg, draws=Draws(SEED + 2, dev), device=dev))
    degree = float(pool.degree().float().mean())
    log(f"[main] build n={n} d={x.shape[1]} {cfg}: {build_s:.2f}s, mean degree {degree:.2f}")
    truth, gt_s = timed(lambda: brute_force_knn(x, queries, k, device=dev))
    log(f"[main] ground truth for {queries.shape[0]} queries: {gt_s:.2f}s")
    recalls, results = {}, {}
    for ef in EF_MAIN:
        before = ops.launch_counts()
        res, s = timed(
            lambda: search(x, pool.ids, queries, k=k, ef=ef, visited="hashed", device=dev)
        )
        after = ops.launch_counts()
        steps, inserts = (
            after.get(name, 0) - before.get(name, 0) for name in ("search_expand", "visited_insert")
        )
        if inserts != steps + 1:
            raise AssertionError(f"ef={ef}: {inserts} visited inserts for {steps} steps")
        ok = (
            res.ids.shape == (queries.shape[0], k)
            and bool(((res.ids >= 0) & (res.ids < n)).all())
            and bool(torch.isfinite(res.dists).all())
        )
        if not ok:
            raise AssertionError(f"search at ef={ef} returned empty or out-of-range results")
        rec = recalls[ef] = recall_at_k(res.ids, truth)
        results[ef] = res
        log(
            f"[main] search ef={ef} hashed: {s:.2f}s, {steps} steps, {inserts} visited inserts, "
            f"{queries.shape[0] / s:.0f} QPS, "
            f"mean n_expanded {float(res.n_expanded.float().mean()):.1f}, recall@10 {rec:.4f} "
            f"(floor {RECALL_FLOOR[ef]})"
        )
        if rec < RECALL_FLOOR[ef]:
            raise AssertionError(f"recall@10 {rec:.4f} below the floor {RECALL_FLOOR[ef]}")
    counts = ops.launch_counts()
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    insert_rows(x, pool.ids, queries, rows)  # after the path's counts are read
    path_counts("main", counts, MAIN_KERNELS, rows)
    log(f"[main] done in {time.perf_counter() - t0:.1f}s")
    return pool, truth, recalls, build_s, results


# ---------------------------------------------------------------------------
# phases 4b and 4c: the dynamic index at int8 and at bf16 traversal, with an
# fp32 rescore tier
# ---------------------------------------------------------------------------


def _check_results(res, q: int, k: int, what: str) -> None:
    ok = (
        tuple(res.ids.shape) == (q, k)
        and bool((res.ids >= 0).all())
        and bool(torch.isfinite(res.dists).all())
    )
    if not ok:
        raise AssertionError(f"{what}: empty, non-finite or misshapen results")


def phase_dynamic(x, queries, cfg, static_recall: float, rows):
    t0 = time.perf_counter()
    dev = x.device
    n, k, nq = x.shape[0], 10, queries.shape[0]
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    pool, build_s = timed(
        lambda: build_graph(x[:DYN_BASE], cfg, draws=Draws(SEED + 20, dev), device=dev)
    )
    log(f"[dynamic] base build n={DYN_BASE}: {build_s:.2f}s")
    idx, s = timed(
        lambda: DynamicIndex(x[:DYN_BASE], pool, DYN_CFG, draws=Draws(SEED + 21, dev), device=dev)
    )
    del pool
    log(
        f"[dynamic] construct {DYN_CFG}: {s:.2f}s (the int8 re-base of "
        f"{DYN_BASE * cfg.r} edges), capacity {idx.capacity}"
    )
    ins_s, per_batch = 0.0, []
    for lo in range(DYN_BASE, n, DYN_BATCH):
        labs, s = timed(lambda: idx.insert(x[lo : lo + DYN_BATCH]))
        if labs.tolist() != list(range(lo, lo + DYN_BATCH)):
            raise AssertionError("insert issued labels out of order")
        ins_s += s
        per_batch.append(s)
    n_ins = n - DYN_BASE
    log(
        f"[dynamic] insert {n_ins} in {n_ins // DYN_BATCH} batches: {ins_s:.2f}s, "
        f"{n_ins / ins_s:.0f} vectors/s (batches {min(per_batch):.2f}-{max(per_batch):.2f}s), "
        f"rounds_run {idx.rounds_run}, capacity {idx.capacity}"
    )
    # labels are the rows of x: the inserts came in order after the base
    res, s = timed(lambda: idx.search(queries, k=k, ef=64, visited="hashed"))
    _check_results(res, nq, k, "dynamic search")
    truth, gt_s = timed(lambda: idx.exact_knn(queries, k))
    rec = recall_at_k(res.ids, truth)
    log(
        f"[dynamic] search ef=64 hashed + fp32 rescore: {s:.2f}s, {nq / s:.0f} QPS, "
        f"recall@10 {rec:.4f} (static fp32 graph {static_recall:.4f}, floor "
        f"{DYN_RECALL_FLOOR}); exact_knn {gt_s:.2f}s"
    )
    if rec < DYN_RECALL_FLOOR:
        raise AssertionError(f"dynamic recall@10 {rec:.4f} below {DYN_RECALL_FLOOR}")

    g = torch.Generator(dev).manual_seed(SEED + 22)
    dels = torch.randperm(n, generator=g, device=dev)[:DYN_DELETE]
    removed, s = timed(lambda: idx.delete(dels))
    if removed != DYN_DELETE or idx.size != n:
        raise AssertionError(f"delete removed {removed} (size {idx.size})")
    res, search_s = timed(lambda: idx.search(queries, k=k, ef=64, visited="hashed"))
    _check_results(res, nq, k, "search after delete")
    if bool(torch.isin(res.ids, dels).any()):
        raise AssertionError("a deleted label came back from the search")
    rec_live = recall_at_k(res.ids, idx.exact_knn(queries, k))
    log(
        f"[dynamic] delete {DYN_DELETE}: {s:.3f}s; search {search_s:.2f}s, "
        f"{nq / search_s:.0f} QPS, no deleted label returned, recall@10 against the "
        f"live ground truth {rec_live:.4f}"
    )

    qc = queries[:DYN_COMPACT_Q]
    before = idx.search(qc, k=k, ef=64, visited="dense")
    _, s = timed(idx.compact)
    after = idx.search(qc, k=k, ef=64, visited="dense")
    if not torch.equal(before.ids, after.ids):
        bad = int((before.ids != after.ids).any(1).sum())
        raise AssertionError(f"compact() changed the dense search of {bad} queries")
    log(
        f"[dynamic] compact: {s:.2f}s, size {idx.size}, capacity {idx.capacity}; dense "
        f"search of {DYN_COMPACT_Q} queries identical before and after "
        f"(dists equal: {torch.equal(before.dists, after.dists)})"
    )
    counts = ops.launch_counts()
    log(f"[dynamic] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    path_counts("dynamic", counts, DYN_KERNELS, rows)
    log(f"[dynamic] done in {time.perf_counter() - t0:.1f}s")
    return idx


def phase_bf16(x, queries, cfg, rows) -> None:
    """4c: the dynamic index at bf16 traversal on the SIFT1M-shaped corpus,
    the path of the bf16 rows."""
    t0 = time.perf_counter()
    dev = x.device
    n, nq = x.shape[0], queries.shape[0]
    ops.reset_launch_counts()
    pool = build_graph(x[:DYN_BASE], cfg, draws=Draws(SEED + 13, dev), device=dev)
    idx, s = timed(
        lambda: DynamicIndex(
            x[:DYN_BASE],
            pool,
            DYN_CFG._replace(precision="bf16"),
            draws=Draws(SEED + 14, dev),
            device=dev,
        )
    )
    del pool
    log(f"[bf16] construct (the bf16 re-base of {DYN_BASE * cfg.r} edges): {s:.2f}s")
    ins_s = 0.0
    for lo in range(DYN_BASE, n, DYN_BATCH):
        ins_s += timed(lambda: idx.insert(x[lo : lo + DYN_BATCH]))[1]
    res, s = timed(lambda: idx.search(queries, k=10, ef=64, visited="hashed"))
    counts = ops.launch_counts()
    _check_results(res, nq, 10, "bf16 search")
    rec = recall_at_k(res.ids, idx.exact_knn(queries, 10))
    log(
        f"[bf16] insert {n - DYN_BASE} in {(n - DYN_BASE) // DYN_BATCH} batches: "
        f"{ins_s:.2f}s, {(n - DYN_BASE) / ins_s:.0f} vectors/s; search ef=64 hashed + fp32 "
        f"rescore: {s:.2f}s, {nq / s:.0f} QPS, recall@10 {rec:.4f} (floor {DYN_RECALL_FLOOR})"
    )
    if rec < DYN_RECALL_FLOOR:
        raise AssertionError(f"bf16 path recall@10 {rec:.4f} below {DYN_RECALL_FLOOR}")
    path_counts("bf16", counts, BF16_KERNELS, rows)
    log(f"[bf16] done in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phases 4d and 4e: filtered search, the layout pass, and the labeled dynamic
# index with the host rescore tier
# ---------------------------------------------------------------------------


def _same(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


def phase_filtered(x, queries, pool, rows) -> None:
    """4d: filtered search on the phase-4 fp32 graph at three selectivities,
    then the layout pass on the same graph."""
    t0 = time.perf_counter()
    dev = x.device
    n, k, nq = x.shape[0], 10, queries.shape[0]
    g = torch.Generator(dev).manual_seed(SEED + 30)
    store = encode_labels(torch.randint(0, N_LABELS, (n,), generator=g, device=dev), N_LABELS)
    filters = {s: random_query_filters(g, nq, N_LABELS, s) for s in SELECTIVITIES}
    kept = {}
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    for s in SELECTIVITIES:
        fw = filters[s]
        ef = overfetch_ef(n, k, s, 64)
        steps = ops.launch_counts().get("search_expand+filter", 0)
        res, secs = timed(
            lambda: search(
                x, pool.ids, queries, k=k, ef=ef, visited="hashed", labels=store, filter=fw,
                device=dev,
            )
        )
        steps = ops.launch_counts().get("search_expand+filter", 0) - steps
        kept[s] = res
        truth, gt_s = timed(lambda: filtered_brute_force(x, queries, fw, store.words, k))
        frac = predicate_fraction(res.ids, fw, store.words)
        rec = filtered_recall_at_k(res.ids, truth)
        full = float((res.ids >= 0).float().mean())
        log(
            f"[filtered] s={s} ef={ef} hashed: {secs:.2f}s, {nq / secs:.0f} QPS, {steps} steps, "
            f"mean n_expanded {float(res.n_expanded.float().mean()):.1f}, filtered recall@10 "
            f"{rec:.4f} (floor {FILTERED_RECALL_FLOOR[s]}), predicate fraction {frac}, "
            f"filled slots {full:.4f}; filtered_brute_force {gt_s:.2f}s"
        )
        if frac != 1.0:
            raise AssertionError(f"s={s}: {frac} of returned ids satisfy their predicate")
        if rec < FILTERED_RECALL_FLOOR[s]:
            raise AssertionError(f"s={s}: filtered recall@10 {rec:.4f} below the floor")
    counts = ops.launch_counts()
    log(f"[filtered] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    path_counts("filtered", counts, FILTERED_KERNELS, rows)
    # the result-heap merge at the widest ef: W = ef + R = 560
    b, w = nq, 512 + pool.ids.shape[1]
    mi = torch.randint(-1, n, (b, w), generator=g, device=dev, dtype=torch.int32)
    md = torch.rand((b, w), generator=g, device=dev)
    got, want = ops.topr_merge(mi, md, 512), ref.topr_merge_ref(mi, md, 512)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("topr_merge at W = 560 differs from its plain version")
    log(
        f"[filtered] topr_merge B={b} W={w} r=512: {cuda_ms(lambda: ops.topr_merge(mi, md, 512), 5):.3f} "
        f"ms (plain {cuda_ms(lambda: ref.topr_merge_ref(mi, md, 512), 1):.1f} ms), equal"
    )
    del mi, md, got, want

    ops.reset_launch_counts()
    opt, secs = timed(lambda: optimize(x, pool, order="bfs", labels=store, device=dev))
    log(
        f"[layout] optimize(order='bfs') n={n}: {secs:.2f}s, packed degree {opt.degree} "
        f"(pool width {pool.ids.shape[1]})"
    )
    qd, fw = queries[:LAYOUT_Q], filters[0.1][:LAYOUT_Q]
    for f in (None, fw):
        kw = dict(k=k, ef=64, visited="dense", labels=store, filter=f)
        plain = search(x, pool.ids, qd, device=dev, **kw)
        kw.pop("labels")
        laid = opt.search(qd, **kw)
        if not _same(plain, laid):
            raise AssertionError(f"layout changed the dense search (filter={f is not None})")
        log(
            f"[layout] dense search of {LAYOUT_Q} queries, "
            f"{'filtered s=0.1' if f is not None else 'unfiltered'}: ids, dists and "
            "n_expanded bitwise equal with and without the layout"
        )
    qps = {}
    for name, fn in (
        ("plain", lambda: search(x, pool.ids, queries, k=k, ef=64, visited="hashed", device=dev)),
        ("layout", lambda: opt.search(queries, k=k, ef=64, visited="hashed")),
        ("plain", lambda: search(x, pool.ids, queries, k=k, ef=64, visited="hashed", device=dev)),
        ("layout", lambda: opt.search(queries, k=k, ef=64, visited="hashed")),
    ):
        qps.setdefault(name, []).append(nq / timed(fn)[1])
    log(
        "[layout] hashed ef=64 QPS, plain / layout / plain / layout: "
        + " / ".join(f"{a:.0f} / {b:.0f}" for a, b in zip(qps["plain"], qps["layout"]))
    )
    path_counts("layout", ops.launch_counts(), LAYOUT_KERNELS, [])
    log(f"[filtered] done in {time.perf_counter() - t0:.1f}s")
    return store, filters[0.1], kept[0.1]


def phase_tiered(x, queries, cfg, rows) -> None:
    """4e: the labeled dynamic index at int8 traversal with the host rescore
    tier and the BFS layout, on phase 4b's protocol."""
    t0 = time.perf_counter()
    dev = x.device
    n, k, nq = x.shape[0], 10, queries.shape[0]
    g = torch.Generator(dev).manual_seed(SEED + 40)
    vlabels = torch.randint(0, N_LABELS, (n,), generator=g, device=dev)
    fw = random_query_filters(g, nq, N_LABELS, 0.1)
    vw_rows = pack_ids(vlabels, N_LABELS)  # labels are the rows of x here
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    pool = build_graph(x[:DYN_BASE], cfg, draws=Draws(SEED + 41, dev), device=dev)
    idx, s = timed(
        lambda: DynamicIndex(
            x[:DYN_BASE], pool, TIERED_CFG, draws=Draws(SEED + 42, dev), device=dev,
            vertex_labels=vlabels[:DYN_BASE], n_labels=N_LABELS,
        )
    )
    del pool
    log(
        f"[tiered] construct {TIERED_CFG} with {N_LABELS} labels: {s:.2f}s (the int8 re-base "
        f"and the BFS layout); fp32 tier on {idx.x.device}, pinned {idx.x.is_pinned()}"
    )
    ins_s = 0.0
    for lo in range(DYN_BASE, n, DYN_BATCH):
        ins_s += timed(
            lambda: idx.insert(x[lo : lo + DYN_BATCH], vertex_labels=vlabels[lo : lo + DYN_BATCH])
        )[1]
    n_ins = n - DYN_BASE
    log(f"[tiered] insert {n_ins} with labels in {n_ins // DYN_BATCH} batches: {ins_s:.2f}s, "
        f"{n_ins / ins_s:.0f} vectors/s")

    tier = idx._rescore_tier()
    g0, f0 = tier.gather_seconds, tier.fetched_rows
    res, secs = timed(lambda: idx.search(queries, k=k, ef=64, visited="hashed", filter=fw))
    gather_s, fetched = tier.gather_seconds - g0, tier.fetched_rows - f0
    x_dev = idx.x.to(dev)
    dev_res = search(
        idx._tier(), idx.pool.ids, queries, k=k, ef=64, entry=idx.entry(), visited="hashed",
        valid=idx.valid, rescore=x_dev, labels=idx.label_words(), filter=fw, device=dev,
    )
    del x_dev
    if not _same((idx._to_labels(dev_res.ids), dev_res.dists, dev_res.n_expanded), res):
        raise AssertionError("the host rescore tier differs from the device tier")
    _check_results(res, nq, k, "tiered filtered search")
    frac = predicate_fraction(res.ids, fw, vw_rows)
    rec = filtered_recall_at_k(res.ids, idx.exact_knn(queries, k, filter=fw))
    log(
        f"[tiered] filtered search s=0.1 ef=64 hashed + host rescore: {secs:.2f}s, "
        f"{nq / secs:.0f} QPS; host gather {gather_s:.3f}s, traversal and re-rank "
        f"{secs - gather_s:.3f}s, fetched_rows {fetched} of {nq * 64}; bitwise equal to the "
        f"device tier; predicate fraction {frac}; filtered recall@10 {rec:.4f}"
    )
    if frac != 1.0:
        raise AssertionError(f"tiered: {frac} of returned ids satisfy their predicate")

    dels = torch.randperm(n, generator=g, device=dev)[:DYN_DELETE]
    removed, s = timed(lambda: idx.delete(dels))
    if removed != DYN_DELETE:
        raise AssertionError(f"delete removed {removed}")
    _, c_s = timed(idx.compact)
    res, secs = timed(lambda: idx.search(queries, k=k, ef=64, visited="hashed", filter=fw))
    frac = predicate_fraction(res.ids, fw, vw_rows)
    if bool(torch.isin(res.ids, dels).any()):
        raise AssertionError("a deleted label came back from the tiered search")
    if frac != 1.0:
        raise AssertionError(f"tiered after compact: predicate fraction {frac}")
    rec = filtered_recall_at_k(res.ids, idx.exact_knn(queries, k, filter=fw))
    tier = idx._rescore_tier()
    if tier.device_bytes() != 0:
        raise AssertionError("the host rescore tier holds device bytes")
    log(
        f"[tiered] delete {DYN_DELETE}: {s:.3f}s; compact (with the layout pass) {c_s:.2f}s, "
        f"size {idx.size}; filtered search {secs:.2f}s, {nq / secs:.0f} QPS, no deleted label "
        f"returned, predicate fraction {frac}, filtered recall@10 {rec:.4f}; rescore tier "
        f"device bytes {tier.device_bytes()}, host bytes {tier.host_bytes()}"
    )
    counts = ops.launch_counts()
    log(f"[tiered] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    path_counts("tiered", counts, TIERED_KERNELS, rows)
    log(f"[tiered] done in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 3b: the sorted-order ablation; 4f: corpus sharding; 4g: NCCL
# ---------------------------------------------------------------------------


def phase_sorted(x, queries, cfg, truth, disordered_recall: float, disordered_s: float) -> None:
    """3b: ascending and descending builds (paper Alg. 2, Fig. 7) at phase
    4's shape and build config, searched as phase 4 searches."""
    t0 = time.perf_counter()
    dev = x.device
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    for order in ("ascending", "descending"):
        ocfg = cfg._replace(order=order)
        pool, build_s = timed(
            lambda: build_graph(x, ocfg, draws=Draws(SEED + 2, dev), device=dev)
        )
        res, s = timed(
            lambda: search(x, pool.ids, queries, k=10, ef=64, visited="hashed", device=dev)
        )
        rec = recall_at_k(res.ids, truth)
        log(
            f"[sorted] {order} build n={x.shape[0]}: {build_s:.2f}s (disordered "
            f"{disordered_s:.2f}s), mean degree {float(pool.degree().float().mean()):.2f}; "
            f"search ef=64 hashed {s:.2f}s, recall@10 {rec:.4f} (disordered "
            f"{disordered_recall:.4f}, floor {SORTED_FLOOR[order]})"
        )
        if rec < SORTED_FLOOR[order]:
            raise AssertionError(f"{order} build: recall@10 {rec:.4f} below its floor")
        del pool, res
    log(f"[sorted] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    path_counts("sorted", ops.launch_counts(), SORTED_KERNELS, [])
    log(f"[sorted] done in {time.perf_counter() - t0:.1f}s")


def phase_corpus(x, queries, cfg, pool, truth, res64, filtered, idx, rows) -> None:
    """4f: corpus sharding at S = 4 on the SIFT1M-shaped corpus: the
    divide-and-conquer build, and the sharded search of phase 4's graph,
    of 4d's filtered search and of 4b's dynamic index, each bitwise its
    replicated search."""
    t0 = time.perf_counter()
    dev = x.device
    n, k, nq = x.shape[0], 10, queries.shape[0]
    store, fw, res_f = filtered
    want_dyn = idx.search(queries, k=k, ef=64, visited="hashed")  # the replicated reference
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    sp, build_s = timed(
        lambda: CS.sharded_build(
            x, cfg, CORPUS_SHARDS, merge_rounds=MERGE_ROUNDS, cross_candidates=CROSS,
            draws=Draws(SEED + 50, dev), device=dev,
        )
    )
    built = CS.shard(x, sp, CORPUS_SHARDS, device=dev)
    res, s = timed(lambda: built.search(queries, k=k, ef=64, visited="hashed"))
    rec = recall_at_k(res.ids, truth)
    log(
        f"[corpus] sharded_build S={CORPUS_SHARDS} n={n} (merge_rounds {MERGE_ROUNDS}, "
        f"{CROSS} cross candidates): {build_s:.2f}s, mean degree "
        f"{float(sp.degree().float().mean()):.2f}; sharded search ef=64 hashed {s:.2f}s, "
        f"{nq / s:.0f} QPS, recall@10 {rec:.4f} (floor {SHARDED_BUILD_FLOOR})"
    )
    if rec < SHARDED_BUILD_FLOOR:
        raise AssertionError(f"sharded build recall@10 {rec:.4f} below {SHARDED_BUILD_FLOOR}")
    del sp, built, res

    sidx, shard_s = timed(lambda: CS.shard(x, pool, CORPUS_SHARDS, labels=store, device=dev))
    got, s = timed(lambda: sidx.search(queries, k=k, ef=64, visited="hashed"))
    if not _same(got, res64):
        raise AssertionError("the sharded search differs from phase 4's search")
    log(
        f"[corpus] shard() of the phase-4 graph: {shard_s:.2f}s; sharded search ef=64 hashed "
        f"{s:.2f}s, {nq / s:.0f} QPS, recall@10 {recall_at_k(got.ids, truth):.4f}: ids, dists "
        "and n_expanded bitwise phase 4's"
    )
    ef_f = overfetch_ef(n, k, 0.1, 64)
    got, s = timed(lambda: sidx.search(queries, k=k, ef=ef_f, visited="hashed", filter=fw))
    if not _same(got, res_f):
        raise AssertionError("the sharded filtered search differs from 4d's")
    log(
        f"[corpus] sharded filtered search s=0.1 ef={ef_f} hashed: {s:.2f}s, {nq / s:.0f} QPS, "
        "bitwise 4d's"
    )
    got, s = timed(lambda: idx.corpus_search(queries, CORPUS_SHARDS, k=k, ef=64, visited="hashed"))
    if not _same(got, want_dyn):
        raise AssertionError("DynamicIndex.corpus_search differs from its search")
    log(
        f"[corpus] 4b's index corpus_search S={CORPUS_SHARDS} ef=64 hashed + fp32 rescore: "
        f"{s:.2f}s (re-sharding included), {nq / s:.0f} QPS, bitwise its search in label space"
    )
    mem = CS.memory_report(sidx)
    log(
        f"[corpus] memory_report (fp32 rows, graph, label words): per shard "
        f"{mem['per_shard_bytes']} B, replicated {mem['replicated_bytes']} B, n_loc "
        f"{mem['n_loc']}; peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
    )
    path_counts("corpus", ops.launch_counts(), CORPUS_KERNELS, rows)
    log(f"[corpus] done in {time.perf_counter() - t0:.1f}s")


def phase_nccl(cfg, parity) -> None:
    """4g: the torch.distributed paths at world size 1 on NCCL, on phase 3's
    data: each bitwise its single-process counterpart."""
    t0 = time.perf_counter()
    x, queries, truth, parity_recall = parity
    dev = x.device
    n, k = x.shape[0], 10
    base = n - DYN_BATCH
    # the single-process references, outside the counted window
    pool = build_graph(x, cfg, draws=Draws(SEED + 11, dev), device=dev)
    want = search(x, pool.ids, queries, k=k, ef=64, visited="hashed", device=dev)
    pb = build_graph(x[:base], cfg, draws=Draws(SEED + 60, dev), device=dev)
    plain = DynamicIndex(x[:base], pb, DYN_CFG, draws=Draws(SEED + 61, dev), device=dev)
    plain.insert(x[base:])
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=dev)
    try:
        ops.reset_launch_counts()
        got = D.distributed_search(x, pool.ids, queries, k=k, ef=64, visited="hashed", device=dev)
        if not _same(got, want):
            raise AssertionError("distributed_search differs from search")
        idx1 = CS.shard(x, pool, 1, device=dev)
        got = idx1.search(queries, k=k, ef=64, visited="hashed", group=dist.group.WORLD)
        if not _same(got, want):
            raise AssertionError("corpus_sharded_search differs from search")
        log(
            f"[nccl] world size {dist.get_world_size()} on {dist.get_backend()}: "
            "distributed_search and corpus_sharded_search bitwise search"
        )
        routed = DynamicIndex(
            x[:base], pb, DYN_CFG, draws=Draws(SEED + 61, dev), device=dev,
            group=dist.group.WORLD,
        )
        routed.insert(x[base:])
        if not _same(routed.pool, plain.pool):
            raise AssertionError("DynamicIndex(group=) insert differs from the in-process index")
        log(f"[nccl] DynamicIndex(group=) insert of {DYN_BATCH}: the in-process pool, bitwise")
        built, build_s = timed(
            lambda: D.sharded_build_graph(x, cfg, draws=Draws(SEED + 62, dev), device=dev)
        )
        stats = {}
        a2a, a2a_s = timed(
            lambda: D.sharded_build_graph(
                x, cfg, comm="a2a", draws=Draws(SEED + 62, dev), device=dev, stats=stats
            )
        )
        if stats["a2a_dropped"] or not _same(a2a, built):
            raise AssertionError("the a2a build differs from the allgather build")
        res = search(x, built.ids, queries, k=k, ef=64, visited="hashed", device=dev)
        rec = recall_at_k(res.ids, truth)
        log(
            f"[nccl] sharded_build_graph n={n}: allgather {build_s:.2f}s, a2a {a2a_s:.2f}s "
            f"(bitwise equal, 0 dropped); recall@10 {rec:.4f} (phase 3's fp32 build "
            f"{parity_recall:.4f}, gap <= {NCCL_RECALL_GAP})"
        )
        if abs(rec - parity_recall) > NCCL_RECALL_GAP:
            raise AssertionError(f"sharded build recall@10 {rec:.4f} vs {parity_recall:.4f}")
        path_counts("nccl", ops.launch_counts(), NCCL_KERNELS, [])
    finally:
        dist.destroy_process_group()
    log(f"[nccl] done in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 4h: serving (the continuous-batching engine and the serving CLI)
# ---------------------------------------------------------------------------


class Recorder:
    """A worker proxy keeping every batch's inputs and outputs and every
    mutation, in the order the engine ran them."""

    def __init__(self, worker):
        self.worker, self.calls = worker, []

    def search_batch(self, q, *, k, ef, fwords=None):
        ids, dists = self.worker.search_batch(q, k=k, ef=ef, fwords=fwords)
        self.calls.append(("query", q, k, ef, ids, dists, fwords))
        return ids, dists

    def apply_mutation(self, mut):
        self.worker.apply_mutation(mut)
        self.calls.append(("mutation", mut))


class PlainCheck:
    """Within the scope every kernel call made through `ops` runs as it
    would (the kernel, counted among the launches) and is then held against
    its plain version on the same inputs, with phase 2's checks. `calls`
    maps a launch-count name to (calls held, the row counts they came in)."""

    NAMES = (
        "search_expand", "topr_merge", "rowwise_sqdist", "pairwise_sqdist", "visited_insert",
        "rng_propagation_round", "gather_sqdist",
    )

    def __init__(self):
        self.calls: dict = {}
        self.err = 0.0  # the largest distance error held

    def __enter__(self):
        self.real = {name: getattr(ops, name) for name in self.NAMES}
        for name, real in self.real.items():
            setattr(ops, name, functools.partial(getattr(self, "_" + name), real))
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(ops, name, real)

    def _held(self, name: str, rows: int, err: float = 0.0) -> None:
        n, shapes = self.calls.get(name, (0, set()))
        self.calls[name] = (n + 1, shapes | {rows})
        self.err = max(self.err, err)

    @staticmethod
    def _plain(real, *args):
        with ops.backend("ref"):
            return real(*args)

    def _search_expand(self, real, x, queries, nbrs, table, valid=None, vwords=None, fwords=None):
        args = (x, queries, nbrs, table, valid, vwords, fwords)
        got, want = real(*args), self._plain(real, *args)
        name = _build.variant(
            "search_expand", ops.parts(x)[0].dtype, valid=valid is not None,
            filter=vwords is not None,
        )
        q = queries.shape[0]
        if not all(torch.equal(got[i], want[i]) for i in range(len(got)) if i != 1):
            raise AssertionError(f"{name} at Q={q}: ids / fresh / allowed differ from the plain version")
        live = want[0] >= 0
        self._held(name, q, close(got[1][live], want[1][live], f"{name} at Q={q}"))
        return got

    def _topr_merge(self, real, ids, dists, r, flags=None):
        got, want = real(ids, dists, r, flags), self._plain(real, ids, dists, r, flags)
        name = "topr_merge" if flags is None else "topr_merge/flags"
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name} at {tuple(ids.shape)}: differs from the plain version")
        self._held(name, ids.shape[0])
        return got

    def _rowwise_sqdist(self, real, x, y):
        got, want = real(x, y), self._plain(real, x, y)
        self._held("rowwise_sqdist", x.shape[0], close(got, want, "rowwise_sqdist"))
        return got

    def _pairwise_sqdist(self, real, x, y):
        got, want = real(x, y), self._plain(real, x, y)
        xs, ys = (ref.dequant_rows(*ops.parts(t)) for t in (x, y))
        scale = (xs * xs).sum(-1)[:, None] + (ys * ys).sum(-1)[None, :]
        err = (got - want).abs()
        name = _build.variant("pairwise_sqdist", ops.parts(x)[0].dtype, ops.parts(y)[0].dtype)
        if bool((err > PAIRWISE_REL * scale + 1e-6).any()):
            raise AssertionError(f"{name} at M={xs.shape[0]}: outside its tolerance")
        self._held(name, xs.shape[0], float(err.max()))
        return got

    def _visited_insert(self, real, table, ids):
        before = table.clone()
        got = real(table, ids)
        if not torch.equal(got, self._plain(real, before, ids)):
            raise AssertionError(f"visited_insert at {tuple(table.shape)}: differs from the loop")
        self._held("visited_insert", table.shape[0])
        return got

    def _rng_propagation_round(self, real, x, ids, dists, si, sj):
        args = (x, ids, dists, si, sj)
        got, want = real(*args), self._plain(real, *args)
        err, _ = check_rng_round(got, want, dists, si, sj)
        self._held(_build.variant("rng_round", ops.parts(x)[0].dtype), ids.shape[0], err)
        return got

    def _gather_sqdist(self, real, x, ni, nj):
        got, want = real(x, ni, nj), self._plain(real, x, ni, nj)
        name = _build.variant("gather_sqdist", ops.parts(x)[0].dtype)
        self._held(name, ni.shape[0], close(got, want, name))
        return got

    def summary(self, needed) -> str:
        """The calls held, by kernel; raises unless every kernel of
        `needed` was held at least once."""
        missing = [name for name in needed if name not in self.calls]
        if missing:
            raise AssertionError(f"no call held against its plain version: {missing}")
        return ", ".join(
            f"{name} {n} at rows {sorted(rows)}" for name, (n, rows) in sorted(self.calls.items())
        )


def plain_checked(label: str, worker, calls, needed, same: bool, then=None) -> None:
    """The first engine batch of every (rows, ef, filtered) shape in
    `calls` (a Recorder's), rerun through `worker` under PlainCheck; its
    result bitwise the engine's where `same` (the worker's state is the one
    the batch ran on). `then(worker)` runs last, under the same check."""
    t0 = time.perf_counter()
    firsts: dict = {}
    for call in calls:
        if call[0] == "query":
            firsts.setdefault((call[1].shape[0], call[3], call[6] is not None), call)
    with PlainCheck() as chk:
        for _, q, k, ef, ids, dists, fw in firsts.values():
            got = worker.search_batch(q, k=k, ef=ef, fwords=fw)
            if same and not (np.array_equal(got[0], ids) and np.array_equal(got[1], dists)):
                raise AssertionError(f"{label}: a batch rerun under the check differs")
        if then is not None:
            then(worker)
    log(
        f"[serving] {label}: every kernel call of {len(firsts)} engine batches (the first of "
        f"each (rows, ef, filtered) shape) held against its plain version, max abs dist err "
        f"{chk.err:.3g} ({time.perf_counter() - t0:.2f}s): {chk.summary(needed)}"
    )


def serve_trace(label: str, worker, make_trace, nq: int):
    """serve --engine's protocol: a closed-loop replay of the whole trace
    (everything at t = 0) measures the capacity, then the open-loop replay
    at SERVE_LOAD x capacity. Returns (engine, trace, rids, stats of the
    open loop, the closed loop's log)."""
    eng = AE.AnnEngine(worker, AE.EngineConfig(**SERVE_CFG))
    t0 = time.perf_counter()
    warm = AE.replay(eng, [dataclasses.replace(ev, t=0.0) for ev in make_trace(1.0)])
    for rid in warm.values():
        eng.take_result(rid)
    w = eng.stats()
    capacity = max(w.qps, 1.0)
    warm_log = list(eng.log)
    probe_s = time.perf_counter() - t0
    eng.reset_stats()
    offered = SERVE_LOAD * capacity
    trace = make_trace(offered)
    t0 = time.perf_counter()
    rids = AE.replay(eng, trace)
    s = eng.stats()
    if w.n_completed != nq or s.n_completed != nq or w.n_rejected or s.n_rejected:
        raise AssertionError(f"{label}: {w.n_completed} / {s.n_completed} of {nq} completed")
    mut = ""
    if s.n_mutations:
        mut = f", {s.mutations_per_sec:.0f} mutations/s ({s.n_mutations} vectors)"
    log(
        f"[serving] {label}: capacity {capacity:.0f} QPS (closed loop, {nq} requests in "
        f"{probe_s:.2f}s, p99 {w.p99_ms:.1f} ms); open loop offered {offered:.0f} QPS: achieved "
        f"{s.qps:.0f} QPS, p50 {s.p50_ms:.2f} ms, p99 {s.p99_ms:.2f} ms, occupancy "
        f"{s.mean_occupancy:.3f}, n_buckets {s.n_buckets}, completed {s.n_completed}, "
        f"rejected {s.n_rejected}{mut}; {time.perf_counter() - t0:.2f}s"
    )
    return eng, trace, rids, s, warm_log


def _same_rows(got, ids, dists, k: int) -> bool:
    return np.array_equal(got.ids, ids[:k]) and np.array_equal(got.dists, dists[:k])


def twin_of(idx):
    """A `DynamicIndex` holding a copy of `idx`'s state (its own buffers,
    the same stateless draws)."""
    return DynamicIndex.from_state(
        x=idx.x.clone(),
        store=None if idx.store is None else idx.store._replace(data=idx.store.data.clone()),
        pool=Pool(idx.pool.ids.clone(), idx.pool.dists.clone()),
        valid=idx.valid.clone(),
        labels=idx.labels.clone(),
        size=idx.size,
        n_live=idx.n_live,
        next_label=idx._next_label,
        entry=None if idx._entry is None else idx._entry.clone(),
        rounds_run=idx.rounds_run,
        vlabels=None if idx.vlabels is None else idx.vlabels.clone(),
        n_labels=idx.n_labels,
        cfg=idx.cfg,
        draws=idx.draws,
        device=idx.device,
    )


def recall_of(got, trace, rows, truth) -> float:
    """recall@k of the results `got[i]` for the requests `rows` of `trace`,
    each at its own k, against phase 4's truth."""
    hits = sum(len(set(got[i].ids.tolist()) & set(truth[i, : trace[i].k].tolist())) for i in rows)
    return hits / sum(trace[i].k for i in rows)


def serving_static(x, queries, pool, truth, store, fw, k_cap: int):
    """The static worker over phase 4's graph: every other request filtered
    at s = 0.1 against 4d's labels; each result bitwise its row of one
    direct search per (ef, filtered) group, the first SERVE_Q1 also of a
    Q = 1 search; every kernel call of one batch a shape held against its
    plain version."""
    dev = x.device
    nq = queries.shape[0]
    q_np, fw_np = queries.cpu().numpy(), fw.cpu().numpy()
    fwords = [fw_np[i] if i % 2 == 0 else None for i in range(nq)]

    def make(offered):
        return AE.synth_trace(
            np.random.default_rng(SEED + 70), q_np, offered_qps=offered, k_choices=SERVE_K,
            ef_choices=SERVE_EF, fwords=fwords,
        )

    ops.reset_launch_counts()
    worker = AE.StaticWorker(x, pool.ids, visited="hashed", labels=store, device=dev)
    rec = Recorder(worker)
    eng, trace, rids, s, _ = serve_trace("static", rec, make, nq)
    path_counts("serving-static", ops.launch_counts(), SERVE_KERNELS["static"], [])
    got = [eng.take_result(rids[i]) for i in range(nq)]  # query i is event i (no churn)

    t0 = time.perf_counter()
    cfg = AE.EngineConfig(**SERVE_CFG)
    groups: dict = {}
    for i, ev in enumerate(trace):
        key = (AE.normalize_ef(cfg, ev.k, ev.ef, ev.fwords is not None), ev.fwords is not None)
        groups.setdefault(key, []).append(i)
    bad = 0
    for (ef, filt), rows in sorted(groups.items()):
        r_t = torch.tensor(rows, device=dev)
        res = search(
            x, pool.ids, queries[r_t], k=min(k_cap, ef), ef=ef, entry=worker.entry,
            visited="hashed", labels=store if filt else None, filter=fw[r_t] if filt else None,
            overfetch=1, device=dev,
        )
        ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
        bad += sum(not _same_rows(got[i], ids[j], dists[j], trace[i].k) for j, i in enumerate(rows))
    for i in range(SERVE_Q1):
        filt = trace[i].fwords is not None
        res = search(
            x, pool.ids, queries[i : i + 1], k=trace[i].k,
            ef=AE.normalize_ef(cfg, trace[i].k, trace[i].ef, filt), entry=worker.entry,
            visited="hashed", labels=store if filt else None,
            filter=fw[i : i + 1] if filt else None, overfetch=1, device=dev,
        )
        bad += not _same_rows(got[i], res.ids.cpu().numpy()[0], res.dists.cpu().numpy()[0],
                              trace[i].k)
    if bad:
        raise AssertionError(f"static engine: {bad} results differ from the direct searches")
    plain = [i for i in range(nq) if trace[i].fwords is None]
    recall = recall_of(got, trace, plain, truth)
    filt_rows = [i for i in range(nq) if trace[i].fwords is not None]
    ids_f = torch.full((len(filt_rows), max(SERVE_K)), -1, dtype=torch.int64)
    for j, i in enumerate(filt_rows):
        ids_f[j, : trace[i].k] = torch.from_numpy(got[i].ids.astype(np.int64))
    frac = predicate_fraction(
        ids_f.to(dev), fw[torch.tensor(filt_rows, device=dev)], store.words
    )
    log(
        f"[serving] static: every result bitwise its row of {len(groups)} direct searches (one a "
        f"(ef, filtered) group at k_exec, sliced to k) and the first {SERVE_Q1} of Q = 1 "
        f"searches ({time.perf_counter() - t0:.2f}s); recall@k of the {len(plain)} unfiltered "
        f"requests {recall:.4f} (floor {SERVE_RECALL_FLOOR}); predicate fraction of the "
        f"{len(filt_rows)} filtered {frac}"
    )
    if frac != 1.0 or recall < SERVE_RECALL_FLOOR:
        raise AssertionError(f"static engine: predicate fraction {frac}, recall {recall:.4f}")

    def construct(_):  # the worker's medoid (B5 at M = 1), under the check too
        again = AE.StaticWorker(x, pool.ids, visited="hashed", labels=store, device=dev)
        if not torch.equal(again.entry, worker.entry):
            raise AssertionError("static worker: the entry differs under the check")

    plain_checked("static", worker, rec.calls, SERVE_KERNELS["static"], same=True, then=construct)
    return trace, s


def serving_dynamic(x, queries, idx):
    """The dynamic worker on 4b's int8 index with churn; the log replayed
    on a twin index from the same state: every result bitwise."""
    dev = x.device
    g = torch.Generator(dev).manual_seed(SEED + 71)
    churn = [
        synthetic.queries_from(g, x, SERVE_CHURN, noise=0.1).cpu().numpy()
        for _ in range(SERVE_DYN_Q // SERVE_CHURN_EVERY)
    ]
    q_np = queries[:SERVE_DYN_Q].cpu().numpy()

    def make(offered):
        return AE.synth_trace(
            np.random.default_rng(SEED + 72), q_np, offered_qps=offered, k_choices=SERVE_K,
            ef_choices=SERVE_EF, mutation_every=SERVE_CHURN_EVERY, churn_vectors=churn,
        )

    twin = twin_of(idx)
    ops.reset_launch_counts()
    rec = Recorder(AE.DynamicWorker(idx, visited="hashed"))
    eng, _, _, _, warm_log = serve_trace("dynamic", rec, make, SERVE_DYN_Q)
    path_counts("serving-dynamic", ops.launch_counts(), SERVE_KERNELS["dynamic"], [])

    t0 = time.perf_counter()
    entries = warm_log + eng.log
    if len(entries) != len(rec.calls):
        raise AssertionError("dynamic engine: the log and the worker's calls disagree")
    bad = batches = 0
    for (kind, key, n), call in zip(entries, rec.calls):
        if kind == "query":
            _, q, k, ef, ids, dists, _ = call
            res = twin.search(torch.from_numpy(q[:n]), k=k, ef=ef, visited="hashed", overfetch=1)
            bad += not (
                np.array_equal(res.ids.cpu().numpy(), ids[:n])
                and np.array_equal(res.dists.cpu().numpy(), dists[:n])
            )
            batches += 1
        elif key == "insert":
            twin.insert(torch.from_numpy(call[1].vectors))
        else:
            twin.delete(twin.oldest_live(n))
    same = _same((idx.pool.ids, idx.labels, idx.valid), (twin.pool.ids, twin.labels, twin.valid))
    if bad or not same:
        raise AssertionError(f"dynamic engine: {bad} of {batches} batches differ from the twin")
    log(
        f"[serving] dynamic: the log's {batches} query batches and "
        f"{len(entries) - batches} mutations replayed on a twin index: every result, the pools, "
        f"labels and validity bitwise ({time.perf_counter() - t0:.2f}s); size {idx.size}, "
        f"live {idx.n_live}, rounds_run {idx.rounds_run}"
    )
    inserts = [c[1] for c in rec.calls if c[0] == "mutation" and c[1].kind == "insert"]

    def churn_pair(worker):  # the twin moves on: one more insert and delete_oldest
        worker.apply_mutation(inserts[0])
        worker.apply_mutation(AE.MutationRequest(kind="delete_oldest", n_items=SERVE_CHURN))

    # the batches rerun on the twin's final state: the kernels against their
    # plain versions, not the results against the engine's
    plain_checked(
        "dynamic", AE.DynamicWorker(twin, visited="hashed"), rec.calls, SERVE_KERNELS["dynamic"],
        same=False, then=churn_pair,
    )


def serving_sharded(x, queries, pool, truth, static_trace, k_cap: int):
    """The sharded worker over phase 4's graph at S = 4: the static trace's
    first SERVE_SHARD_Q requests unfiltered, each result bitwise its row
    of a replicated search per ef; every kernel call of one batch a shape
    held against its plain version."""
    dev = x.device
    sidx = CS.shard(x, pool, CORPUS_SHARDS, device=dev)
    events = [dataclasses.replace(ev, fwords=None) for ev in static_trace[:SERVE_SHARD_Q]]
    rate = SERVE_SHARD_Q / events[-1].t  # the static trace's arrival rate

    def make(offered):
        return [dataclasses.replace(ev, t=ev.t * rate / offered) for ev in events]

    ops.reset_launch_counts()
    worker = AE.ShardedWorker(sidx, visited="hashed")
    rec = Recorder(worker)
    eng, trace, rids, _, _ = serve_trace(f"sharded S={CORPUS_SHARDS}", rec, make, SERVE_SHARD_Q)
    path_counts("serving-sharded", ops.launch_counts(), SERVE_KERNELS["sharded"], [])
    got = [eng.take_result(rids[i]) for i in range(SERVE_SHARD_Q)]
    cfg = AE.EngineConfig(**SERVE_CFG)
    bad = 0
    for ef in sorted({AE.normalize_ef(cfg, ev.k, ev.ef, False) for ev in trace}):
        rows = [i for i, ev in enumerate(trace) if AE.normalize_ef(cfg, ev.k, ev.ef, False) == ef]
        res = search(
            x, pool.ids, queries[torch.tensor(rows, device=dev)], k=min(k_cap, ef), ef=ef,
            entry=sidx.entry, visited="hashed", overfetch=1, device=dev,
        )
        ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
        bad += sum(not _same_rows(got[i], ids[j], dists[j], trace[i].k) for j, i in enumerate(rows))
    recall = recall_of(got, trace, range(SERVE_SHARD_Q), truth)
    if bad or recall < SERVE_RECALL_FLOOR:
        raise AssertionError(
            f"sharded engine: {bad} results differ from the replicated search, recall {recall:.4f}"
        )
    log(
        f"[serving] sharded: every result bitwise its row of the replicated search at its ef; "
        f"recall@k {recall:.4f} (floor {SERVE_RECALL_FLOOR})"
    )
    plain_checked(
        f"sharded S={CORPUS_SHARDS}", worker, rec.calls, SERVE_KERNELS["sharded"], same=True
    )


def cli_fields(line: str) -> dict:
    """The serving CLI's stats line as {name: value}: every field a number
    (a trailing "ms" dropped) but the named words."""
    words = {"backend", "visited", "precision", "tier", "opt_layout", "device"}
    out = {}
    for name, value in (f.split("=", 1) for f in line.split() if "=" in f):
        out[name] = value if name in words else float(value.removesuffix("ms"))
    return out


def serving_cli(dev) -> None:
    """The serving CLI in process on a sift-small index built by the
    port's build_index CLI, one run a mode; the launch counts zeroed and
    read around the build and around each mode."""
    out_dir = Path(__file__).resolve().parent / "build" / "serve_cli"
    out_dir.mkdir(parents=True, exist_ok=True)
    index = str(out_dir / "sift-small.idx.npz")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        built = build_cli.main(["--dataset", "sift-small", "--out", index, "--device", str(dev)])
    path_counts("serving-cli-build", ops.launch_counts(), SERVE_KERNELS["build"], [])
    log(
        f"[serving] cli build_index --dataset sift-small: {time.perf_counter() - t0:.2f}s "
        f"(build {built['build_s']:.2f}s, recall@10 {built['recall_at_10']:.4f})"
    )
    for name, extra, kernels in SERVE_CLI:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = serve_cli.main(["--index", index, "--device", str(dev), *extra])
        path_counts(f"serving-cli-{name}", ops.launch_counts(), SERVE_CLI_EVERY + kernels, [])
        f = cli_fields(out["line"])
        if f.get("pred_ok", 1.0) != 1.0 or not f["device"].startswith(dev.type):
            raise AssertionError(f"cli {name}: {out['line']}")
        log(f"[serving] cli {name} ({time.perf_counter() - t0:.2f}s): {out['line']}")


def phase_serving(x, queries, pool, truth, filtered, idx, card: str) -> None:
    """4h: the engine's three workers at full width, then the serving CLI;
    one engine batch under the profiler (the host's share of a batch)."""
    t0 = time.perf_counter()
    dev = x.device
    store, fw, _ = filtered
    k_cap = AE.EngineConfig().k_cap
    log(f"[serving] on {card} (nvidia-smi name, power limit)")
    torch.cuda.reset_peak_memory_stats(dev)
    truth_np = truth.cpu().numpy()
    nq = SERVE_STATIC_Q
    trace, _ = serving_static(x, queries[:nq], pool, truth_np[:nq], store, fw[:nq], k_cap)
    # one full batch as the engine runs it: 32 rows, ef 64, hashed
    worker = AE.StaticWorker(x, pool.ids, visited="hashed", device=dev)
    q32 = queries[: SERVE_CFG["max_batch"]].cpu().numpy()
    worker.search_batch(q32, k=k_cap, ef=64)
    profiled("engine batch: static worker, 32 queries, ef 64 hashed",
             lambda: worker.search_batch(q32, k=k_cap, ef=64))
    serving_dynamic(x, queries, idx)
    serving_sharded(x, queries, pool, truth_np, trace, k_cap)
    serving_cli(dev)
    log(f"[serving] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    log(f"[serving] done in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phases 4i and 4j: kNN-LM at gemma3-1b's and deepseek-moe-16b's full width
# (the LM stack, the serving engine's hooks and retrieval over the dynamic
# index)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def moe_drops():
    """Within the scope every `moe_block` call's `moe_drop_frac` (a device
    scalar) is appended to the list yielded, in call order."""
    fracs, real = [], MOE.moe_block

    def recorded(*a, **kw):
        out, aux = real(*a, **kw)
        fracs.append(aux["moe_drop_frac"])
        return out, aux

    MOE.moe_block = recorded
    try:
        yield fracs
    finally:
        MOE.moe_block = real


def knn_harvest(params, cfg, tokens, chunk: int):
    """(keys (B·(S-1), D) fp32, next tokens) of every position but the last
    of each sequence: post-`final_norm` hidden states of bf16 forwards,
    `chunk` sequences a forward."""
    b, s = tokens.shape
    keys = torch.empty((b * (s - 1), cfg.d_model), dtype=torch.float32, device=tokens.device)
    with torch.no_grad():
        for lo in range(0, b, chunk):
            h, _ = LM.forward(params, cfg, {"tokens": tokens[lo : lo + chunk]},
                              act_dtype=torch.bfloat16, return_hidden=True)
            keys[lo * (s - 1) : (lo + h.shape[0]) * (s - 1)] = h[:, :-1].reshape(-1, cfg.d_model)
    return keys, tokens[:, 1:].reshape(-1).contiguous()


def matmul_flop(cfg, n_tokens: int) -> float:
    """2 x the active non-embedding parameters x tokens: the forward's
    matmuls without the embedding and the output head."""
    heads = 1 if cfg.tie_embeddings else 2
    return 2.0 * (cfg.active_param_count() - heads * cfg.vocab * cfg.d_model) * n_tokens


def knn_twin(ds):
    """A `DynamicDatastore` holding a copy of `ds`'s state."""
    return KNN.DynamicDatastore(
        twin_of(ds.index), ds.values.clone(), ds.vocab, k=ds.k, ef=ds.ef, tau=ds.tau,
        visited=ds.visited,
    )


def knn_generate(ds, params, cfg, prompts, dev):
    """The retrieval-fused greedy generation: tokens, seconds, and the
    seconds spent in the streaming inserts."""
    spent = [0.0]
    add = ds.add

    def timed_add(*a, **kw):
        out, s = timed(lambda: add(*a, **kw))
        spent[0] += s
        return out

    ds.add = timed_add
    try:
        stream = KNN.make_stream_hook(ds, insert_every=KNN_INSERT_EVERY)
        eng = ServeEngine(cfg, params, s_max=prompts.shape[1] + KNN_NEW, act_dtype=torch.bfloat16,
                          logit_hook=KNN.make_logit_hook(ds, lam=KNN_LAM), token_hook=stream,
                          device=dev)
        out, s = timed(lambda: eng.generate({"tokens": prompts}, max_new_tokens=KNN_NEW))
        _, s_flush = timed(stream.flush)
    finally:
        del ds.add
    return out["tokens"], s + s_flush, spent[0]


def knn_chunked(fn, q, chunk: int = 1024) -> torch.Tensor:
    return torch.cat([fn(q[lo : lo + chunk]) for lo in range(0, q.shape[0], chunk)])


def knn_take(into: dict) -> None:
    """Add the launch counts since the last reset to `into`, and reset."""
    for name, c in ops.launch_counts().items():
        into[name] = into.get(name, 0) + c
    ops.reset_launch_counts()


def knn_witness(keys, held, g, dev, klog, states_out) -> None:
    """The port on the witness subset (KNN_WIT_*): a build and a search at
    ef 32 (dense visited set, as the reference searches) through the
    kernels and through the plain versions for each seed, read by recall
    and distance excess; with `states_out` the states, the samples and the
    truth go to an npz for tests/_knn_witness.py."""
    n = keys.shape[0]
    sub = torch.randperm(n, generator=g, device=dev)[:KNN_WIT_N].sort().values
    wx, wq = keys[sub], held[:KNN_WIT_Q]
    if not (torch.equal(wx.bfloat16().float(), wx) and torch.equal(wq.bfloat16().float(), wq)):
        raise AssertionError("the harvested states are not bf16 values")
    verts = torch.randperm(KNN_WIT_N, generator=g, device=dev)[:KNN_WIT_V]
    rq = torch.randint(0, KNN_WIT_N, (KNN_WIT_Q, 10), generator=g, device=dev)
    rv = torch.randint(0, KNN_WIT_N, (KNN_WIT_V, 10), generator=g, device=dev)
    truth = brute_force_knn(wx, wq, 10, device=dev)
    vknn = brute_force_knn(wx, wx[verts], 11, device=dev)[:, 1:]
    for seed in KNN_WIT_SEEDS:
        for name in ("auto", "ref"):
            with ops.backend(name):
                pool = build_graph(wx, KNN.DEFAULT_BUILD_CFG, draws=Draws(seed, dev), device=dev)
                res = search(wx, pool.ids, wq, k=10, ef=KNN_EF, device=dev)
            klog(f"witness subset ({KNN_WIT_N} keys, {KNN_WIT_Q} held-out states), "
                 f"{'kernels' if name == 'auto' else 'plain versions'}, seed {seed}: recall@10 "
                 f"at ef {KNN_EF} {recall_at_k(res.ids, truth):.4f}, excess "
                 f"{distance_excess(wx, wq, res.ids, truth, rq):.4f}; pools hold "
                 f"{recall_at_k(pool.ids[verts], vknn):.4f} of the true 10-NN, excess "
                 f"{pool_excess(wx, verts, pool.ids, vknn, rv):.4f}")
    if states_out:
        def bits(t):
            return t.bfloat16().view(torch.int16).cpu().numpy()

        def cpu(t):
            return t.cpu().numpy()

        Path(states_out).parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(states_out, x=bits(wx), q=bits(wq), verts=cpu(verts), rq=cpu(rq),
                            rv=cpu(rv), truth=cpu(truth), vknn=cpu(vknn))
        klog(f"witness states saved to {states_out} ({Path(states_out).stat().st_size} B)")


def knn_seed_builds(keys, held, smp, rv, rq, klog) -> None:
    """2^18-pair builds through the kernels and the plain versions at each
    seed: the pools' excess, and the held-out search's over each graph,
    within KNN_EXCESS_GAP at one seed."""
    dev, gap = keys.device, KNN_EXCESS_GAP
    sub = keys[:KNN_FP32_N]
    in_sub = smp < KNN_FP32_N
    sub_smp, sub_rv, sub_rq = smp[in_sub], rv[in_sub] % KNN_FP32_N, rq % KNN_FP32_N
    sub_knn = brute_force_knn(sub, sub[sub_smp], 11, device=dev)[:, 1:]
    sub_truth = brute_force_knn(sub, held, 10, device=dev)
    built = {}
    for seed in KNN_BUILD_SEEDS:
        for name in ("auto", "ref"):
            with ops.backend(name):
                sub_pool = build_graph(sub, KNN.DEFAULT_BUILD_CFG, draws=Draws(seed, dev),
                                       device=dev)
                res = search(sub, sub_pool.ids, held, k=10, ef=KNN_EF, visited="hashed",
                             device=dev)
            built[seed, name] = (
                recall_at_k(sub_pool.ids[sub_smp], sub_knn),
                pool_excess(sub, sub_smp, sub_pool.ids, sub_knn, sub_rv),
                distance_excess(sub, held, res.ids, sub_truth, sub_rq),
            )
            klog(f"the first {KNN_FP32_N} pairs built and searched through the "
                 f"{'kernels' if name == 'auto' else 'plain versions'}, seed {seed}: pools hold "
                 "{:.4f} of the true 10-NN, excess {:.4f}; search excess {:.4f}".format(
                     *built[seed, name]))
    del sub_pool, sub_knn, res
    spread = [max(abs(built[a, "ref"][i] - built[b, "ref"][i]) for a in KNN_BUILD_SEEDS
                  for b in KNN_BUILD_SEEDS) for i in (1, 2)]
    worst = [max(abs(built[s, "auto"][i] - built[s, "ref"][i]) for s in KNN_BUILD_SEEDS)
             for i in (1, 2)]
    klog(f"2^18-pair builds: kernels against plain versions at one seed differ by at most "
         f"{worst[0]:.4f} (pools) / {worst[1]:.4f} (search) in excess; plain builds of "
         f"seeds {KNN_BUILD_SEEDS} by {spread[0]:.4f} / {spread[1]:.4f} (gap {gap})")
    if max(worst) > gap:
        raise AssertionError(f"the kernels' builds differ from the plain versions' by {worst} in "
                             f"excess, over {gap}")


def vote_expected(ids, dists, toks, tau: float):
    """The vote's winner recomputed in fp64: each retrieved token's summed
    softmax(-d / tau) weight over the valid slots. Returns (the winning
    token, its weight, the best other token's weight) per query."""
    w = torch.softmax(-dists.double() / tau, dim=-1) * (ids >= 0)
    same = toks[:, :, None] == toks[:, None, :]
    per_slot = (same * w[:, None, :]).sum(-1)  # each slot's token's summed weight
    best = per_slot.argmax(1, keepdim=True)
    token = toks.gather(1, best)[:, 0]
    other = torch.where(toks == token[:, None], 0.0, per_slot).amax(1)
    return token, per_slot.gather(1, best)[:, 0], other


def knn_memorization(ds, params, cfg, keys, vals, pos, g, klog, need_majority: bool = True) -> float:
    """Stored keys as queries; returns the memorization share (the vote's
    argmax is the stored token). Where the search retrieves the key's own row
    (distance 0), the vote's argmax must be the token of the largest summed
    weight (recomputed in fp64; near-ties of 1e-6 aside), and where the
    stored token holds a majority of the vote's weight (no other token can
    outvote it) it must be the stored token; the fused NLL stays within
    -log(1 - lam) of the pure LM's and beats it on the own-row queries.
    (Other rows within tau of the query, carrying a repeated token, can
    outvote the own row: at deepseek-moe-16b's states a sequence's nearby
    positions lie at squared distances 1-4 of each other, tau 10.) Without
    `need_majority` a run in which no stored token holds a majority may
    pass: a trained model's states of one current token lie within squared
    distance ~0.5 of each other, tau 10, so the vote spreads over their
    many next tokens (4l)."""
    n, dev = keys.shape[0], keys.device
    memo = torch.nonzero(pos[:n] >= KNN_MIN_POS)[:, 0]
    memo = memo[torch.randperm(memo.shape[0], generator=g, device=dev)[:KNN_MEMO]]
    q, tgt = keys[memo], vals[memo].long()
    found = [ds._search(q[lo : lo + 1024], k=KNN_K, ef=KNN_EF) for lo in range(0, KNN_MEMO, 1024)]
    ids, dists = torch.cat([f[0] for f in found]), torch.cat([f[1] for f in found])
    own = (ids == memo[:, None]).any(1)
    klp = knn_chunked(ds.knn_log_probs, q)
    hit = klp.argmax(-1) == tgt
    token, top, other = vote_expected(ids, dists, ds.values[ids.clamp_min(0).long()].long(),
                                      ds.tau)
    agree = (klp.argmax(-1) == token) | (top - other <= 1e-6 * top)
    major = own & (token == tgt) & (top > 0.5)
    pure_q, fused_q = [], []
    for lo in range(0, KNN_MEMO, 1024):
        lm = LM.lm_logits(params, cfg, q[lo : lo + 1024])
        t = tgt[lo : lo + 1024, None]
        pure_q.append(-torch.log_softmax(lm, -1).gather(1, t)[:, 0])
        fused_q.append(-KNN.fuse(lm, klp[lo : lo + 1024], KNN_LAM).gather(1, t)[:, 0])
    pure_q, fused_q = torch.cat(pure_q), torch.cat(fused_q)
    del klp
    n_own, n_major = int(own.sum()), int(major.sum())
    acc_own = float(hit[own].float().mean()) if n_own else 0.0
    acc_major = float(hit[major].float().mean()) if n_major else 0.0
    agree_own = int(agree[own].sum())
    pure, fused = float(pure_q.mean()), float(fused_q.mean())
    pure_own, fused_own = float(pure_q[own].mean()), float(fused_q[own].mean())
    bound = -math.log1p(-KNN_LAM)
    klog(f"memorization of {KNN_MEMO} stored pairs (positions >= {KNN_MIN_POS}): own row "
         f"retrieved for {n_own}; vote argmax = stored token on {float(hit.float().mean()):.4f} "
         f"of all, on {acc_own:.4f} of those; the vote's argmax is the fp64 weight argmax on "
         f"{agree_own} of {n_own}; the stored token holds a majority of the weight on {n_major}, "
         f"the vote picks it on {acc_major:.4f} of them (floor {KNN_OWN_FLOOR}); NLL pure LM "
         f"{pure:.4f}, kNN-fused (lam {KNN_LAM}) {fused:.4f} (at most pure + {bound:.4f}); on "
         f"the own-row queries {pure_own:.4f} -> {fused_own:.4f}")
    if (need_majority and n_major == 0) or agree_own < n_own or (
        n_major and acc_major < KNN_OWN_FLOOR
    ) or (
        fused > pure + bound + 1e-4
    ) or not fused_own < pure_own:
        raise AssertionError("the vote or the fusion broke on stored keys")
    return float(hit.float().mean())


def knn_fp32_and_routing(ds, keys, vals, held, cfg, seed: int, dev, klog) -> None:
    """The fp32 datastore on the first 2^18 pairs bitwise the array-backed
    path, and the engine-routed retrieval bitwise the direct one."""
    # the fp32 datastore on the first 2^18 pairs: bitwise the array-backed path
    k32, v32 = keys[:KNN_FP32_N], vals[:KNN_FP32_N]
    ds32, s32 = timed(lambda: KNN.DynamicDatastore.build(
        k32, v32, cfg.vocab, precision="fp32", draws=Draws(seed + 3, dev), device=dev,
        k=KNN_K, ef=KNN_EF, visited="hashed"))
    store = KNN.build_datastore(k32, v32, draws=Draws(seed + 3, dev), device=dev)
    if not torch.equal(store.graph, ds32.index.pool.ids[:KNN_FP32_N]):
        raise AssertionError("two builds of the same pairs and draws gave different graphs")
    got = ds32.knn_log_probs(held)
    want = KNN.knn_logits(store, held, cfg.vocab, k=KNN_K, ef=KNN_EF, entry=ds32.index.entry(),
                          valid=ds32.index.valid[:KNN_FP32_N], visited="hashed")
    if not torch.equal(got, want):
        raise AssertionError("the fp32 datastore differs from the array-backed path")
    del ds32, store, got, want
    klog(f"fp32 datastore of {KNN_FP32_N} pairs ({s32:.2f}s): knn_log_probs of "
        f"{KNN_HELD} states bitwise knn_logits on the array-backed store (same entry, valid)")

    # engine routing: the AnnEngine's batches bitwise the direct search
    q = held[:KNN_ROUTED]
    direct = ds.knn_log_probs(q)
    engine = ds.attach_engine()
    try:
        routed, s = timed(lambda: ds.knn_log_probs(q))
    finally:
        ds._engine = None
    if not torch.equal(routed, direct):
        raise AssertionError("the engine-routed retrieval differs from the direct search")
    st = engine.stats()
    klog(f"attach_engine() retrieval of {KNN_ROUTED} queries bitwise the direct search: "
        f"{s:.2f}s, p50 {st.p50_ms:.1f} ms, p99 {st.p99_ms:.1f} ms, {st.n_buckets} buckets")
    del direct, routed


def phase_knn(spec: KnnSpec, card: str, rows, dev, states_out=None, params=None) -> None:
    """4i / 4j / 4l: kNN-LM at a model's full width (over `params`, else
    random weights drawn from the seed): harvest (with the MoE
    blocks' drop shares), the datastore's build, recall and distance excess
    (kernels against plain versions and against a random graph; with
    `spec.full` also 2^18-pair builds at two seeds and the witness subset),
    memorization, with `spec.full` the fp32 datastore against the
    array-backed path and engine routing, retrieval-fused generation
    replayed on a twin, every kernel call of one decode step's retrieval and
    one streaming insert held against its plain version, and phase 2's rows
    at the model's width (with `spec.rows`); with `spec.floors` recall@10
    at ef 32 and the memorization share read against KNN_FLOORS. The
    path's launches are counted over the datastore's build, one
    source-filtered retrieval and the generation; the checks' launches
    apart."""
    t0 = time.perf_counter()
    cfg = get_arch(spec.arch)
    tag, seed = spec.label, SEED + spec.seed

    def klog(msg: str) -> None:  # every line with the card's name and power limit
        log(f"[{tag}] {msg} ({card})")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    if params is None:
        params, init_s = timed(lambda: LM.init_params(cfg, seed=seed, dtype=spec.dtype,
                                                      device=dev))
        drawn = f"drawn in {init_s:.2f}s"
    else:
        drawn = "trained"
    n_params = sum(p.numel() for p in params.parameters())
    weights = "fp32 master weights" if spec.dtype == torch.float32 else "bf16 weights"
    klog(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab}, "
         f"param_count() {cfg.param_count()} ({n_params} held, {weights}, "
         f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB, {drawn})")
    g = torch.Generator(dev).manual_seed(seed + 1)
    tokens = token_stream(g, spec.seqs + KNN_HELD_SEQS, KNN_SEQ_LEN, cfg.vocab)
    with moe_drops() as drops:
        (keys, vals), harvest_s = timed(lambda: knn_harvest(params, cfg, tokens, spec.chunk))
    s1 = KNN_SEQ_LEN - 1
    n = spec.seqs * s1
    pos = torch.arange(keys.shape[0], device=dev) % s1
    held = keys[n:][pos[n:] >= KNN_MIN_POS][:KNN_HELD]
    keys, vals = keys[:n], vals[:n]
    sources = (torch.arange(spec.seqs, device=dev) * KNN_SOURCES // spec.seqs).repeat_interleave(s1)
    flop = matmul_flop(cfg, tokens.numel())
    klog(f"harvest {tokens.shape[0]} x {KNN_SEQ_LEN} tokens (bf16 activations, {spec.chunk} "
         f"sequences a forward): {harvest_s:.2f}s, {n} stored pairs + {held.shape[0]} held-out "
         f"states, {flop / harvest_s / 1e12:.1f} TFLOP/s of the active non-embedding matmuls")
    if drops:  # one value a MoE layer a forward, in call order
        layers = sum(1 for _, kind in LM.layer_descs(cfg) if kind == "moe")
        per_layer = torch.stack(drops).reshape(-1, layers).mean(0)
        c = MOE._capacity(cfg, spec.chunk * KNN_SEQ_LEN)
        klog(f"harvest's moe_drop_frac over {len(drops) // layers} forwards x {layers} MoE layers "
             f"(capacity {c} an expert at T = {spec.chunk * KNN_SEQ_LEN}): per-layer mean "
             f"{float(per_layer.mean()):.4f}, max {float(per_layer.max()):.4f}")
    if held.shape[0] != KNN_HELD or not bool(torch.isfinite(keys).all()):
        raise AssertionError("the harvest gave non-finite or too few hidden states")

    # the path's launches (the build, one filtered retrieval, the
    # generation) and the checks' between them, counted apart
    path, checks = {}, {}
    ops.reset_launch_counts()

    # the build and the dynamic index's construction, timed apart
    build_s = [0.0]
    real_build = grnnd_mod.build_graph

    def build_timed(*a, **kw):
        out, s = timed(lambda: real_build(*a, **kw))
        build_s[0] += s
        return out

    grnnd_mod.build_graph = build_timed
    try:
        ds, total_s = timed(lambda: KNN.DynamicDatastore.build(
            keys, vals, cfg.vocab, build_cfg=KNN.DEFAULT_BUILD_CFG, precision="int8",
            sources=sources.to(torch.int32), n_sources=KNN_SOURCES, draws=Draws(seed + 2, dev),
            device=dev, k=KNN_K, ef=KNN_EF, visited="hashed"))
    finally:
        grnnd_mod.build_graph = real_build
    knn_take(path)
    idx = ds.index
    del keys
    keys = idx.x[:n]  # the fp32 tier holds the stored keys
    klog(f"DynamicDatastore.build {KNN.DEFAULT_BUILD_CFG}: build {build_s[0]:.2f}s, "
        f"construction (int8 re-base of {n * idx.r} edges) {total_s - build_s[0]:.2f}s, "
        f"capacity {idx.capacity}, mean degree {float(idx.pool.degree()[:n].float().mean()):.2f}")

    # the geometry of the states and the graph; recall of the held-out
    # states against the brute-force truth and the distance excess, through
    # the kernels, through their plain versions, and on a random graph
    truth, gt_s = timed(lambda: brute_force_knn(keys, held, 10, device=dev))
    d_true = ((held[:, None, :] - keys[truth.long()]) ** 2).sum(-1)
    rq = torch.randint(0, n, (KNN_HELD, 10), generator=g, device=dev)
    d_rand = float(((held - keys[rq[:, 0]]) ** 2).sum(-1).median())
    cur = tokens[:, :-1].reshape(-1)
    held_cur = cur[n:][pos[n:] >= KNN_MIN_POS][:KNN_HELD]
    share = float((cur[:n][truth.long()] == held_cur[:, None]).float().mean())
    smp = torch.randint(0, n, (KNN_HELD,), generator=g, device=dev)
    rv = torch.randint(0, n, (KNN_HELD, 10), generator=g, device=dev)
    smp_knn = brute_force_knn(keys, keys[smp], 11, device=dev)[:, 1:]
    pool_rec = recall_at_k(idx.pool.ids[smp], smp_knn)
    pool_exc = pool_excess(keys, smp, idx.pool.ids, smp_knn, rv)
    rand_pools = torch.randint(0, n, (n, idx.r), generator=g, device=dev, dtype=torch.int32)
    rand_pool_exc = pool_excess(keys, smp, rand_pools, smp_knn, rv)
    klog(f"state geometry: every key's norm {float(keys[:4096].norm(dim=1).mean()):.2f}; median "
         f"squared distance of a held-out state to its 1st / 10th true neighbor "
         f"{float(d_true[:, 0].median()):.1f} / {float(d_true[:, 9].median()):.1f}, to a random "
         f"stored key {d_rand:.1f}; {share:.4f} of the true 10-NN share the query's current "
         f"token; the pools hold {pool_rec:.4f} of their vertices' true 10-NN, excess "
         f"{pool_exc:.4f} (random pools {rand_pool_exc:.4f}); truth {gt_s:.2f}s")
    recs, excs = {}, {}
    for ef in KNN_RECALL_EFS:
        res, s = timed(lambda ef=ef: idx.search(held, k=10, ef=ef, visited="hashed"))
        ratio = float((res.dists[:, 9] / d_true[:, 9]).mean())
        recs[ef] = recall_at_k(res.ids, truth)
        excs[ef] = distance_excess(keys, held, res.ids, truth, rq)
        klog(f"held-out search at ef {ef} (int8 + fp32 rescore, hashed): recall@10 "
             f"{recs[ef]:.4f}, excess {excs[ef]:.4f}, found / true 10th distance {ratio:.4f}; "
             f"{s:.2f}s")
    with ops.backend("ref"):
        res = idx.search(held, k=10, ef=KNN_EF, visited="hashed")
    plain, plain_exc = recall_at_k(res.ids, truth), distance_excess(keys, held, res.ids, truth, rq)
    res = search(keys, rand_pools, held, k=10, ef=KNN_EF, visited="hashed", device=dev)
    rand_exc = distance_excess(keys, held, res.ids, truth, rq)
    del rand_pools, res
    klog(f"at ef {KNN_EF}, plain versions: recall@10 {plain:.4f}, excess {plain_exc:.4f} "
         f"(kernels {recs[KNN_EF]:.4f}, {excs[KNN_EF]:.4f}); a random graph of degree {idx.r} "
         f"searched through the kernels: excess {rand_exc:.4f}")
    gap = KNN_EXCESS_GAP
    if abs(plain_exc - excs[KNN_EF]) > gap or excs[KNN_EF] > rand_exc - KNN_CONTROL_GAPS * gap or (
        pool_exc > rand_pool_exc - KNN_CONTROL_GAPS * gap
    ):
        raise AssertionError(f"the search's excess: kernels {excs[KNN_EF]:.4f}, plain versions "
                             f"{plain_exc:.4f} (gap {gap}), a random graph {rand_exc:.4f}; the "
                             f"pools' {pool_exc:.4f}, random pools {rand_pool_exc:.4f}")

    if spec.full:
        knn_seed_builds(keys, held, smp, rv, rq, klog)
        knn_witness(keys, held, g, dev, klog, states_out)
    for q in (KNN_PROMPTS, KNN_HELD):
        _, s = timed(lambda q=q: ds.knn_log_probs(held[:q]))
        klog(f"retrieval + vote at Q={q}: {s:.3f}s, {q / s:.0f} QPS")

    # memorization: stored keys as queries; where the search retrieves the
    # key's own row (distance 0), the vote must pick its stored token
    memorized = knn_memorization(ds, params, cfg, keys, vals, pos[:n], g, klog,
                                 need_majority=not spec.floors)
    if spec.full:
        knn_fp32_and_routing(ds, keys, vals, held, cfg, seed, dev, klog)

    # a source-filtered retrieval (on the path): every vote from source 0's pairs
    knn_take(checks)
    klp0 = ds.knn_log_probs(held[:KNN_ROUTED], filter=torch.zeros((KNN_ROUTED,), dtype=torch.int32,
                                                                   device=dev))
    knn_take(path)
    voted = torch.isfinite(klp0)
    ids, _ = ds._search(held[:KNN_ROUTED], k=KNN_K, ef=KNN_EF,
                        filter=torch.zeros((KNN_ROUTED,), dtype=torch.int32, device=dev))
    live = ids[ids >= 0].long()
    if not bool(voted.any(1).all()) or bool((sources[live] != 0).any()):
        raise AssertionError("the source-0 filtered retrieval left its source or lost support")
    del klp0, voted

    # retrieval-fused generation, replayed on a twin from the same state
    twin = knn_twin(ds)
    prompts = token_stream(g, KNN_PROMPTS, KNN_PROMPT_LEN, cfg.vocab)
    n0 = len(ds)
    knn_take(checks)
    toks, gen_s, ins_s = knn_generate(ds, params, cfg, prompts, dev)
    knn_take(path)
    grew = len(ds) - n0
    if toks.shape != (KNN_PROMPTS, KNN_NEW) or grew != KNN_PROMPTS * KNN_NEW:
        raise AssertionError(f"generation gave {tuple(toks.shape)}; the datastore grew {grew}")
    twin_toks, twin_s, _ = knn_generate(twin, params, cfg, prompts, dev)
    same = (
        torch.equal(toks, twin_toks)
        and torch.equal(ds.index.pool.ids, twin.index.pool.ids)
        and torch.equal(ds.index.pool.dists, twin.index.pool.dists)
        and torch.equal(ds.index.labels, twin.index.labels)
        and torch.equal(ds.index.valid, twin.index.valid)
        and torch.equal(ds.values, twin.values)
    )
    if not same:
        raise AssertionError("the twin's generation or datastore differs")
    del twin
    plain_eng = ServeEngine(cfg, params, s_max=KNN_PROMPT_LEN + KNN_NEW, act_dtype=torch.bfloat16,
                            device=dev)
    _, plain_s = timed(lambda: plain_eng.generate({"tokens": prompts}, max_new_tokens=KNN_NEW))
    new = KNN_PROMPTS * KNN_NEW
    klog(f"generation {KNN_PROMPTS} x ({KNN_PROMPT_LEN} + {KNN_NEW}) greedy, bf16: with "
        f"the hooks {gen_s:.2f}s, {new / gen_s:.0f} tokens/s (twin {twin_s:.2f}s); without "
        f"{plain_s:.2f}s, {new / plain_s:.0f} tokens/s; {grew} pairs streamed in "
        f"({n0} -> {len(ds)}), inserts {ins_s:.2f}s, {grew / ins_s:.0f} pairs/s; tokens, "
        "pools, labels, validity and token table bitwise the twin's")
    klog(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    # where a step's time goes: the prefill, one decode step and one step's
    # retrieval under the profiler (counted among the checks)
    with torch.no_grad():
        (logits, caches, plen, _), s = timed(lambda: LM.prefill(
            params, cfg, {"tokens": prompts}, s_max=KNN_PROMPT_LEN + KNN_NEW,
            act_dtype=torch.bfloat16, return_hidden=True))
        klog(f"prefill of {KNN_PROMPTS} x {KNN_PROMPT_LEN} tokens: {s:.3f}s")
        tok = logits.argmax(-1).to(torch.int32)
        at = torch.full((KNN_PROMPTS,), plen, dtype=torch.int32, device=dev)
        profiled(f"one decode step of {cfg.name}, {KNN_PROMPTS} rows, bf16",
                 lambda: LM.decode_step(params, cfg, caches, tok, at, act_dtype=torch.bfloat16))
        del caches, logits
    profiled(f"one decode step's retrieval + vote, Q = {KNN_PROMPTS}",
             lambda: ds.knn_log_probs(held[:KNN_PROMPTS]))

    # every kernel call of one streaming insert and one decode step's
    # retrieval (after it: the entry is recomputed) against its plain version
    hs = held[: KNN_PROMPTS * KNN_INSERT_EVERY]
    t1 = time.perf_counter()
    with PlainCheck() as chk:
        ds.add(hs, vals[: hs.shape[0]])
        ds.knn_log_probs(held[:KNN_PROMPTS])
    klog(f"one streaming insert of {hs.shape[0]} pairs and one decode step's retrieval "
        f"(Q={KNN_PROMPTS}): every kernel call held against its plain version, max abs dist "
        f"err {chk.err:.3g} ({time.perf_counter() - t1:.2f}s): {chk.summary(KNN_PLAIN)}")
    knn_take(checks)
    klog(f"launches of the checks, not the path: { {k: v for k, v in sorted(checks.items()) if v} }")
    if spec.floors:
        for what, got in (("recall@10 at ef 32", recs[KNN_EF]), ("memorization", memorized)):
            floor = KNN_FLOORS[what.split()[0]]
            klog(f"floor: {what} {got:.4f} against {floor}: "
                 f"{'met' if got >= floor else 'UNMET (recorded, not lowered)'}")
    if spec.rows:
        knn_rows(idx, held, rows, spec)
    path_counts(tag, path, KNN_KERNELS, rows)
    klog(f"done in {time.perf_counter() - t0:.1f}s")


def knn_rows(idx, held, rows, spec: KnnSpec) -> None:
    """Phase 2's rows at a kNN-LM phase's shapes (D = 1152 in 4i, 2048 in
    4j), on the datastore's N stored rows: B1 fp32 over its pool (C = N)
    and int8 at one streaming insert's frontier, B3 int8 + valid at Q = 32
    and 1,000, B6 int8 over the re-base's N x 24 pairs, B4 at the init's
    owner-distance block, B5 at the medoid and the truth; with `spec.full`
    also B3 fp32 + valid and B6 fp32, without it B1's direct reads forced
    on the fp32 row's inputs (bitwise the staged path's output)."""
    t0 = time.perf_counter()
    tag = spec.label
    keys = idx.x[: idx.size]
    dev = keys.device
    n, d = keys.shape
    r = idx.r
    g = torch.Generator(dev).manual_seed(SEED + spec.seed + 5)
    measure = functools.partial(kernel_row, rows)
    ids, dists = idx.pool.ids[:n], idx.pool.dists[:n]
    data8, sc8, of8 = idx.store.data[:n], idx.store.scale, idx.store.offset
    sdo = 2 * d * 4
    p = KNN.DEFAULT_BUILD_CFG.pairs_per_vertex
    si = torch.randint(0, r, (n, p), generator=g, device=dev, dtype=torch.int32)
    sj = torch.randint(0, r, (n, p), generator=g, device=dev, dtype=torch.int32)

    def rng_check(got, want, dists=dists, si=si, sj=sj):
        err, ties = check_rng_round(got, want, dists, si, sj)
        return err, f"; {ties} dst mismatches at near-ties"

    b1_bytes, b1_ops = unique_rows(ids) * d * 4 + n * r * 9 + n * p * 20, 3 * n * p * d
    measure(
        f"rng_round[{tag}]", "src/repro_torch/kernels/csrc/rng_round.cu",
        "src/repro/kernels/rng_round.py:124",
        lambda: rng_round(keys, ids, dists, si, sj),
        lambda: ref.rng_round_ref(keys, ids, dists, si, sj),
        rng_check, b1_bytes, b1_ops, None, 5, launches_of="rng_round",
    )
    if not spec.full:
        staged = rng_round(keys, ids, dists, si, sj)

        def direct_check(got, want):
            if not all(torch.equal(a, b) for a, b in zip(got, staged)):
                raise AssertionError(f"rng_round's direct reads differ from its staged rows at D = {d}")
            err, extra = rng_check(got, want)
            return err, extra + "; bitwise the staged path"

        measure(
            f"rng_round+direct[{tag}]", "src/repro_torch/kernels/csrc/rng_round.cu",
            "src/repro/kernels/rng_round.py:124",
            lambda: rng_round(keys, ids, dists, si, sj, _direct=True),
            lambda: ref.rng_round_ref(keys, ids, dists, si, sj),
            direct_check, b1_bytes, b1_ops, None, 5, launches_of="rng_round+direct",
        )
        del staged
    del si, sj
    # one streaming insert's frontier: the batch and its seed neighbors
    c1 = KNN_PROMPTS * KNN_INSERT_EVERY * (1 + idx.cfg.seed_k)
    p1 = idx.cfg.pairs_per_vertex
    fr = torch.randint(0, n, (c1,), generator=g, device=dev)
    f_ids, f_dists = ids[fr].contiguous(), dists[fr].contiguous()
    f_si = torch.randint(0, r, (c1, p1), generator=g, device=dev, dtype=torch.int32)
    f_sj = torch.randint(0, r, (c1, p1), generator=g, device=dev, dtype=torch.int32)
    measure(
        f"rng_round/int8[{tag}]", "src/repro_torch/kernels/csrc/rng_round.cu",
        "src/repro/kernels/rng_round.py:124",
        lambda: rng_round(data8, f_ids, f_dists, f_si, f_sj, sc8, of8),
        lambda: ref.rng_round_ref(data8, f_ids, f_dists, f_si, f_sj, sc8, of8),
        lambda got, want: rng_check(got, want, f_dists, f_si, f_sj),
        unique_rows(f_ids) * d + sdo + c1 * r * 9 + c1 * p1 * 20, 3 * c1 * p1 * d + c1 * r * 2 * d,
        None, 20, launches_of="rng_round/int8",
    )

    def expand_check(got, want):
        if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])):
            raise AssertionError(f"search_expand ids / fresh differ at D = {d}")
        ok = want[0] >= 0
        return close(got[1][ok], want[1][ok], f"search_expand dists at D = {d}"), ""

    valid = idx.valid[:n]
    h = default_visited_cap(KNN_EF)
    for q in (KNN_PROMPTS, KNN_HELD):
        queries = held[:q].contiguous()
        nbrs = ids[torch.randint(0, n, (q,), generator=g, device=dev)].contiguous()
        table = torch.full((q, h), -1, dtype=torch.int32, device=dev)
        _table_insert(table, ids[torch.randint(0, n, (q,), generator=g, device=dev)])
        live = int((nbrs >= 0).sum())
        common = q * d * 4 + q * r * 13 + min(q * h, live * 8) * 4 + unique_rows(nbrs)
        for name, data, sc, of, size, dq in (
            ("search_expand/int8+valid", data8, sc8, of8, 1, 2 * d),
            ("search_expand+valid", keys, None, None, 4, 0),
        )[: 2 if spec.full else 1]:
            measure(
                f"{name}[{tag},Q={q}]", "src/repro_torch/kernels/csrc/search_expand.cu",
                "src/repro/kernels/search_expand.py:170",
                lambda data=data, sc=sc, of=of, a=(queries, nbrs, table, valid): search_expand(
                    data, a[0], a[1], a[2], a[3], sc, of),
                lambda data=data, sc=sc, of=of, a=(queries, nbrs, table, valid): (
                    ref.search_expand_ref(data, a[0], a[1], a[2], a[3], sc, of)),
                expand_check, unique_rows(nbrs) * d * size + (sdo if sc is not None else 0) + common,
                live * (3 * d + dq), None, 20, launches_of=name,
            )
    # the re-base's pairs: every pool edge of the N built rows
    owners = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(r)
    nj = ids.clamp_min(0).reshape(-1).contiguous()
    m = owners.shape[0]
    rows_m = unique_rows(torch.cat([owners, nj]))
    chunk = max(1, (1 << 22) * 128 // d)
    for name, data, sc, of, size, dq in (
        ("gather_sqdist/int8", data8, sc8, of8, 1, 4 * d),
        ("gather_sqdist", keys, None, None, 4, 0),
    )[: 2 if spec.full else 1]:
        gathered_ms = ((m + n) * d * size + m * 12) / PEAK_BYTES_PER_S * 1e3
        measure(
            f"{name}[{tag}]", "src/repro_torch/kernels/csrc/gather_l2.cu",
            "src/repro/kernels/gather_l2.py:52",
            lambda data=data, sc=sc, of=of: gather_sqdist(data, owners, nj, sc, of),
            lambda data=data, sc=sc, of=of: ref.gather_sqdist_ref(data, owners, nj, sc, of),
            lambda got, want, name=name, g_ms=gathered_ms: (
                close(got, want, f"{name} at D = {d}"), f"; gathered-rows bound {g_ms:.3f} ms"),
            rows_m * d * size + (sdo if sc is not None else 0) + m * 12, m * (3 * d + dq),
            lambda data=data, sc=sc, of=of: gathered_sqdist(data, owners, nj, sc, of, chunk=chunk),
            3, launches_of=name,
        )
    del owners, nj
    # the init's owner-distance block (pools.OWNER_BLOCK vertices x s)
    s = KNN.DEFAULT_BUILD_CFG.s
    blk = min(n, 1 << 16)
    xo = keys[:blk].repeat_interleave(s, 0)
    xn = keys[ids[:blk, :s].clamp_min(0).reshape(-1).long()]
    mb = xo.shape[0]
    measure(
        f"rowwise_sqdist[{tag}]", "src/repro_torch/kernels/csrc/pairwise_l2.cu",
        "src/repro/kernels/pairwise_l2.py:155",
        lambda: rowwise_sqdist(xo, xn), lambda: ref.rowwise_sqdist_ref(xo, xn),
        lambda got, want: (close(got, want, f"rowwise_sqdist at D = {d}"), ""),
        2 * mb * d * 4 + mb * 4, 3 * mb * d, lambda: ((xo - xn) ** 2).sum(-1), 10,
        launches_of="rowwise_sqdist",
    )
    del xo, xn

    def pairwise_check(got, want, xq, y):
        scale = (xq * xq).sum(-1)[:, None] + (y * y).sum(-1)[None, :]
        err = (got - want).abs()
        if bool((err > PAIRWISE_REL * scale + 1e-6).any()):
            raise AssertionError(f"pairwise_sqdist outside its tolerance at D = {d}")
        return float(err.max()), ""

    y8 = ref.dequant_rows(data8, sc8, of8)
    cen = y8.mean(0, keepdim=True)
    measure(
        f"pairwise_sqdist/int8[{tag},M=1]", "src/repro_torch/kernels/csrc/pairwise_l2.cu",
        "src/repro/kernels/pairwise_l2.py:80",
        lambda: pairwise_sqdist(cen, data8, None, None, sc8, of8),
        lambda: ref.pairwise_sqdist_ref(cen, data8, None, None, sc8, of8),
        lambda got, want: pairwise_check(got, want, cen, y8),
        d * 4 + n * d + sdo + n * 4, 2 * n * d + n * 2 * d,
        lambda: torch.cdist(cen, y8).square(), 10, launches_of="pairwise_sqdist/int8",
    )
    del y8
    hq = held[:KNN_HELD].contiguous()
    measure(
        f"pairwise_sqdist[{tag},truth]", "src/repro_torch/kernels/csrc/pairwise_l2.cu",
        "src/repro/kernels/pairwise_l2.py:80",
        lambda: pairwise_sqdist(hq, keys), lambda: ref.pairwise_sqdist_ref(hq, keys),
        lambda got, want: pairwise_check(got, want, hq, keys),
        (KNN_HELD + n) * d * 4 + KNN_HELD * n * 4, 2 * KNN_HELD * n * d,
        lambda: torch.cdist(hq, keys).square(), 3, launches_of="pairwise_sqdist",
    )
    torch.cuda.empty_cache()
    log(f"[{tag}] kernel rows at D = {d} done in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 4k: the other families at full width (MoE, Mamba2, the hybrid's
# shared attention, the audio and vision frontends)
# ---------------------------------------------------------------------------


def fam_batch(cfg, g, b: int, s: int) -> dict:
    """`b` prompts of `s` Zipf tokens: (B, S, ncb) for the audio frontend
    (a stream a codebook), and the vision frontend's patch embeddings
    (B, vision_tokens, vision_dim) beside its text tokens."""
    if cfg.modality == "audio_tokens":
        toks = [token_stream(g, b, s, cfg.vocab) for _ in range(cfg.n_codebooks)]
        return {"tokens": torch.stack(toks, dim=-1)}
    batch = {"tokens": token_stream(g, b, s, cfg.vocab)}
    if cfg.modality == "vision_text":
        batch["patch_embeds"] = torch.randn((b, cfg.vision_tokens, cfg.vision_dim), generator=g,
                                            device=g.device)
    return batch


def fam_decode_check(params, cfg, batch) -> float:
    """(b): prefill all but the last token at fp32 activations and MoE
    capacity 16 (no drops), decode it, and hold the step's logits against
    the forward's last position within FAM_TOL; returns the max abs error."""
    cfg16 = dataclasses.replace(cfg, moe_capacity_factor=16.0)
    prompt = {name: t[:, :-1] if name == "tokens" else t for name, t in batch.items()}
    with torch.no_grad():
        hidden, _ = LM.forward(params, cfg16, batch, act_dtype=torch.float32, return_hidden=True)
        full, s_full = LM.lm_logits(params, cfg16, hidden[:, -1]), hidden.shape[1]
        del hidden
        _, caches, plen = LM.prefill(params, cfg16, prompt, s_max=s_full, act_dtype=torch.float32)
        pos = torch.full((full.shape[0],), plen, dtype=torch.int32, device=full.device)
        dec, _ = LM.decode_step(params, cfg16, caches, batch["tokens"][:, -1], pos,
                                act_dtype=torch.float32)
    err = (dec - full).abs()
    if bool((err > FAM_TOL + FAM_TOL * full.abs()).any()) or not bool(torch.isfinite(dec).all()):
        raise AssertionError(f"{cfg.name}: the decode step's logits differ from the forward's last "
                             f"position by up to {float(err.max()):.3g} (rtol / atol {FAM_TOL})")
    return float(err.max())


def fam_datastore(params, cfg, label: str, rows, flog) -> None:
    """A small datastore over the model's states (FAM_DS_SEQS sequences of
    512): its fp32 GRNND build takes B1's direct-read path at this width;
    then an insert of 256 pairs and a retrieval at Q = 32, every kernel call
    held against its plain version. The path's launches are counted and
    must include `rng_round+direct`."""
    dev = params.device
    g = torch.Generator(dev).manual_seed(SEED + 70)
    toks = token_stream(g, FAM_DS_SEQS + 1, 512, cfg.vocab)
    keys, vals = knn_harvest(params, cfg, toks, FAM_DS_SEQS + 1)
    n = FAM_DS_SEQS * 511
    extra, queries = keys[n : n + 256], keys[n + 256 : n + 256 + KNN_PROMPTS]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with PlainCheck() as chk:
        ds = KNN.DynamicDatastore.build(keys[:n], vals[:n], cfg.vocab, precision="int8",
                                        draws=Draws(SEED + 71, dev), device=dev, k=KNN_K,
                                        ef=KNN_EF, visited="hashed")
        ds.add(extra, vals[n : n + 256])
        klp = ds.knn_log_probs(queries)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not bool(torch.isfinite(klp).any(1).all()):
        raise AssertionError(f"{label}: a retrieval over the datastore found no support")
    flog(f"{label}: DynamicDatastore.build of {n} pairs at D = {cfg.d_model} (int8 + fp32 "
         f"rescore), an insert of 256 and a retrieval at Q = {KNN_PROMPTS}, {secs:.2f}s with every "
         f"kernel call held against its plain version, max abs dist err {chk.err:.3g}: "
         f"{chk.summary(('rng_round', 'search_expand/int8+valid', 'gather_sqdist/int8'))}")
    path_counts(label, ops.launch_counts(), FAM_DS_KERNELS, rows)


def direct_rows(rows, dev) -> None:
    """Phase 2's rows of B1's direct-read path at D = 3584 and 4096 (fp32,
    C = N = 2^17, R = P = 24): rows past a block's shared memory."""
    t0 = time.perf_counter()
    measure = functools.partial(kernel_row, rows)
    r = p = 24
    for d in DIRECT_WIDTHS:
        g = torch.Generator(dev).manual_seed(SEED + 60 + d)
        c = n = DIRECT_C
        x = synthetic.vector_dataset(g, n, d)
        ids = torch.randint(0, n, (c, r), generator=g, device=dev, dtype=torch.int32)
        dists = torch.rand((c, r), generator=g, device=dev) * 2 * d
        si = torch.randint(0, r, (c, p), generator=g, device=dev, dtype=torch.int32)
        sj = torch.randint(0, r, (c, p), generator=g, device=dev, dtype=torch.int32)

        def check(got, want, dists=dists, si=si, sj=sj):
            err, ties = check_rng_round(got, want, dists, si, sj)
            return err, f"; {ties} dst mismatches at near-ties"

        measure(
            f"rng_round+direct[D={d}]", "src/repro_torch/kernels/csrc/rng_round.cu",
            "src/repro/kernels/rng_round.py:124",
            lambda x=x, a=(ids, dists, si, sj): rng_round(x, *a),
            lambda x=x, a=(ids, dists, si, sj): ref.rng_round_ref(x, *a),
            check, unique_rows(ids) * d * 4 + c * r * 9 + c * p * 20, 3 * c * p * d, None, 3,
            launches_of="rng_round+direct",
        )
        del x, ids, dists, si, sj
    torch.cuda.empty_cache()
    log(f"[families] B1 direct-read rows done in {time.perf_counter() - t0:.1f}s")


def moe_loop_check(dev) -> float:
    """(d): `moe_block` at deepseek-moe-16b's shapes (64 experts top-6, 2
    shared, d_expert 1408, D = 2048; bf16 weights, fp32 activations,
    capacity 16: no drops) against a per-token loop over MOE_LOOP_T tokens;
    returns the max abs error."""
    cfg = dataclasses.replace(get_arch("deepseek-moe-16b"), moe_capacity_factor=16.0)
    gen = torch.Generator(dev).manual_seed(SEED + 72)
    params = MOE.init_moe_params(gen, cfg, dtype=torch.bfloat16)
    x = torch.randn((1, MOE_LOOP_T, cfg.d_model), generator=gen, device=dev)
    with torch.no_grad():
        got, aux = MOE.moe_block(params, cfg, x)
        xt = x[0]
        _, w, idx = MOE.route(params, cfg, xt)
        sp = params["shared"]
        want = (F.silu(xt @ sp["wi_gate"].float()) * (xt @ sp["wi_up"].float())) @ sp["wo"].float()
        for t in range(MOE_LOOP_T):
            for j in range(cfg.top_k):
                e = int(idx[t, j])
                h = F.silu(xt[t] @ params["wi_gate"][e].float()) * (xt[t] @ params["wi_up"][e].float())
                want[t] += w[t, j] * (h @ params["wo"][e].float())
    err = (got[0] - want).abs()
    if float(aux["moe_drop_frac"]) != 0.0 or bool(
        (err > MOE_LOOP_TOL + MOE_LOOP_TOL * want.abs()).any()
    ):
        raise AssertionError(f"moe_block against the token loop: drop share "
                             f"{float(aux['moe_drop_frac'])}, max abs err {float(err.max()):.3g}")
    return float(err.max())


def ssd_check(dev) -> str:
    """(c): `_ssd_chunked` (fp32, TF32 off) at zamba2-7b's shapes against
    the plain recurrence `ssd_naive` run in fp64, within SSD_TOL at every
    output and state entry; the fp32 recurrence is held to the same. Both
    fp32 results err (the chunked scan up to 2.4e-4 at |y| ~ 140, its
    log-space decays summed over a chunk of 128), so the two fp32 results
    are compared, not checked, against each other: one entry in 7.3M lay
    outside 1e-4 of the fp32 recurrence on an H100 (PERF.md, the SSD finding).
    Returns the log line's numbers."""
    b, s, nh, hd, st = SSD_SHAPE
    g = torch.Generator(dev).manual_seed(SEED + 73)
    xh = torch.randn((b, s, nh, hd), generator=g, device=dev)
    a = torch.sigmoid(torch.randn((b, s, nh), generator=g, device=dev) + 1.0)
    bb = torch.randn((b, s, st), generator=g, device=dev)
    cc = torch.randn((b, s, st), generator=g, device=dev)
    h0 = torch.zeros((b, nh, hd, st), device=dev)
    y, h = SSM._ssd_chunked(xh, a, bb, cc, h0, SSD_CHUNK)
    ny, nh_ = SSM.ssd_naive(xh, a, bb, cc, h0)
    y64, h64 = SSM.ssd_naive(*(t.double() for t in (xh, a, bb, cc, h0)))

    def outside(got, want):
        err = (got.double() - want).abs()
        return float(err.max()), int((err > SSD_TOL + SSD_TOL * want.double().abs()).sum())

    (e_y, n_y), (e_h, n_h) = outside(y, y64), outside(h, h64)
    (e_ny, n_ny), (e_nh, n_nh) = outside(ny, y64), outside(nh_, h64)
    e_f, n_f = outside(y, ny.double())
    line = (f"against the fp64 recurrence: chunked y {e_y:.3g} max abs err ({n_y} of {y.numel()} "
            f"outside), h {e_h:.3g} ({n_h}); the fp32 recurrence y {e_ny:.3g} ({n_ny}), h "
            f"{e_nh:.3g} ({n_nh}); chunked against the fp32 recurrence y {e_f:.3g} ({n_f} "
            f"outside); max |y| {float(y64.abs().max()):.3g}")
    if n_y or n_h or n_ny or n_nh:
        raise AssertionError(f"the SSD scans outside rtol / atol {SSD_TOL} of fp64: {line}")
    return line


def phase_families(card: str, rows, dev) -> None:
    """4k: mamba2-130m, zamba2-7b, musicgen-large and internvl2-2b at full
    depth and width and qwen3-moe-235b-a22b at full width cut to 4 layers,
    each from bf16 random weights, one on the card at a time: (a) two
    greedy generations of FAM_PROMPTS x (FAM_PROMPT_LEN + FAM_NEW) tokens
    bitwise equal, (b) the decode step against the forward's last position,
    and for zamba2 / qwen3 a small datastore over their states (B1's direct
    path); then (c) the chunked SSD scan against the recurrence and (d) the
    MoE block against a token loop. B1's direct-read rows come first."""
    t0 = time.perf_counter()

    def flog(msg: str) -> None:
        log(f"[families] {msg} ({card})")

    direct_rows(rows, dev)
    for name, units in FAMILIES:
        t1 = time.perf_counter()
        cfg = get_arch(name) if units is None else truncate_units(get_arch(name), units)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params, init_s = timed(lambda: LM.init_params(cfg, seed=SEED + 80, dtype=torch.bfloat16,
                                                      device=dev))
        held = sum(p.numel() for p in params.parameters())
        g = torch.Generator(dev).manual_seed(SEED + 81)
        batch = fam_batch(cfg, g, FAM_PROMPTS, FAM_PROMPT_LEN)
        plen = FAM_PROMPT_LEN + (cfg.vision_tokens if cfg.modality == "vision_text" else 0)
        with torch.no_grad():
            _, pre_s = timed(lambda: LM.prefill(params, cfg, batch, s_max=plen + FAM_NEW,
                                                act_dtype=torch.bfloat16))
        eng = ServeEngine(cfg, params, s_max=plen + FAM_NEW, act_dtype=torch.bfloat16, device=dev)
        first, gen_s = timed(lambda: eng.generate(batch, max_new_tokens=FAM_NEW))
        again, _ = timed(lambda: eng.generate(batch, max_new_tokens=FAM_NEW))
        if not torch.equal(first["tokens"], again["tokens"]):
            raise AssertionError(f"{cfg.name}: two greedy generations differ")
        err = fam_decode_check(params, cfg, batch)
        new = FAM_PROMPTS * FAM_NEW
        flog(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {held} parameters "
             f"(bf16, drawn in {init_s:.2f}s); prefill of {FAM_PROMPTS} x {plen} {pre_s:.3f}s; "
             f"generate {FAM_NEW} greedy steps {gen_s:.2f}s, {new / max(gen_s - pre_s, 1e-9):.0f} "
             f"decode tokens/s, tokens {tuple(first['tokens'].shape)} bitwise a second run; "
             f"decode against the forward's last position (fp32 activations, capacity 16) max "
             f"abs err {err:.3g} (tol {FAM_TOL}); peak "
             f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; {time.perf_counter() - t1:.1f}s")
        if name in FAM_DS:
            fam_datastore(params, cfg, FAM_DS[name], rows, flog)
        del params, eng, first, again
    torch.cuda.empty_cache()
    flog(f"(c) _ssd_chunked against ssd_naive at B, S, nh, hd, st = {SSD_SHAPE}, chunk "
         f"{SSD_CHUNK}, rtol / atol {SSD_TOL}: {ssd_check(dev)}")
    flog(f"(d) moe_block at deepseek-moe-16b's shapes against a per-token loop over {MOE_LOOP_T} "
         f"tokens (no drops): max abs err {moe_loop_check(dev):.3g} (rtol / atol {MOE_LOOP_TOL})")
    flog(f"done in {time.perf_counter() - t0:.1f}s")


def train_families(dev, tlog) -> None:
    """One training step of every family at reduced() width on the card
    against the same step on the CPU port (the one the tests hold against
    JAX): the same parameters (drawn on the CPU, carried over), the same
    pipeline batch; the loss within STEP_LOSS_TOL, each gradient leaf
    within STEP_GRAD_TOL of the CPU leaf's largest magnitude; then one
    `make_train_step` step on each side, whose losses agree as well."""
    t0 = time.perf_counter()
    worst = {}
    for arch in ALL_ARCHS:
        cfg = reduced(arch)
        host = LM.init_params(cfg, seed=SEED + 96, device="cpu")
        card = convert.lm_params_from_jax(convert.lm_params_to_jax(host, cfg), cfg, device=dev)
        batch = PIPE.batch_for_step(cfg, 0, STEP_BATCH, STEP_SEQ, seed=SEED, device="cpu")
        on_card = {k: v.to(dev) for k, v in batch.items()}
        loss_h, _, grads_h = TS.loss_and_grads(host, cfg, batch, act_dtype=torch.float32)
        loss_c, _, grads_c = TS.loss_and_grads(card, cfg, on_card, act_dtype=torch.float32)
        err = max((float((grads_c[n].cpu() - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                   for n, g in grads_h.items()))
        finite = all(bool(torch.isfinite(g).all()) for g in grads_c.values())
        steps = []
        for params, b in ((host, batch), (card, on_card)):
            fn = TS.make_train_step(cfg, OPT.AdamWConfig(), act_dtype=torch.float32)
            _, m = fn(TS.TrainState(params, OPT.init(dict(params.named_parameters()))), b)
            steps.append(float(m["loss"]))
        worst[cfg.name] = (abs(float(loss_c) - float(loss_h)), err)
        if (abs(float(loss_c) - float(loss_h)) > STEP_LOSS_TOL or err > STEP_GRAD_TOL or not finite
                or abs(steps[1] - steps[0]) > STEP_LOSS_TOL):
            raise AssertionError(f"{cfg.name}: the card's training step differs from the CPU "
                                 f"port's: loss {float(loss_c)} against {float(loss_h)}, train "
                                 f"step {steps}, gradients {err:.3g} of the leaf's largest")
    tlog(f"one training step a family at reduced() width (batch {STEP_BATCH} x {STEP_SEQ}, fp32 "
         f"activations), the card against the CPU port: loss abs err / the largest gradient "
         f"error over the leaves (of the leaf's largest magnitude): " + ", ".join(
             f"{name} {a:.2g} / {b:.2g}" for name, (a, b) in worst.items())
         + f" (tolerances {STEP_LOSS_TOL} / {STEP_GRAD_TOL}); {time.perf_counter() - t0:.1f}s")


def train_resume(dev, tlog) -> None:
    """RESUME_K steps, `checkpoint.save`, `restore` into a fresh state,
    RESUME_M more, against RESUME_K + RESUME_M uninterrupted steps: every
    parameter and moment leaf and the step bitwise equal. Under
    `torch.use_deterministic_algorithms` (the embedding's backward
    scatter-adds into repeated rows), scoped to this check."""
    cfg = truncate_units(get_arch(TRAIN_ARCH), RESUME_UNITS)
    total = RESUME_K + RESUME_M
    step_fn = TS.make_train_step(cfg, OPT.AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                                      total_steps=total),
                                 act_dtype=torch.bfloat16)

    def fresh():
        params = LM.init_params(cfg, seed=SEED + 95, device=dev)
        return TS.TrainState(params, OPT.init(dict(params.named_parameters())))

    def run(state, lo: int, hi: int):
        for step in range(lo, hi):
            batch = PIPE.batch_for_step(cfg, step, RESUME_BATCH, RESUME_SEQ, device=dev)
            state, _ = step_fn(state, batch)
        return state

    ckpt = Path(__file__).resolve().parent / "build" / "train_resume"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.use_deterministic_algorithms(True)
    try:
        straight, run_s = timed(lambda: run(fresh(), 0, total))
        state = run(fresh(), 0, RESUME_K)
        like = convert.train_state_to_jax(state, cfg)
        _, save_s = timed(lambda: CKPT.save(ckpt, RESUME_K, like))
        del state
        tree, restore_s = timed(lambda: CKPT.restore(ckpt, CKPT.latest_step(ckpt), like))
        resumed = run(convert.train_state_from_jax(tree, cfg, device=dev), RESUME_K, total)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt, ignore_errors=True)
    pairs = list(zip(straight.params.parameters(), resumed.params.parameters()))
    for name in straight.opt.mu:
        pairs += [(straight.opt.mu[name], resumed.opt.mu[name]),
                  (straight.opt.nu[name], resumed.opt.nu[name])]
    same = sum(torch.equal(a, b) for a, b in pairs)
    tlog(f"resume: {cfg.name} ({cfg.n_layers} layers at full width, batch {RESUME_BATCH} x "
         f"{RESUME_SEQ}, bf16 activations, deterministic algorithms): {RESUME_K} steps, save "
         f"({sum(1 for _ in CKPT.leaves_with_paths(like))} leaves, "
         f"{save_s:.2f}s), restore into a fresh state ({restore_s:.2f}s), {RESUME_M} more, "
         f"against {total} straight ({run_s:.2f}s): {same} of {len(pairs)} parameter and moment "
         f"leaves bitwise equal, step {int(resumed.opt.step)} / {int(straight.opt.step)}")
    if same != len(pairs) or int(resumed.opt.step) != int(straight.opt.step):
        raise AssertionError("resumed training differs from uninterrupted training")


def phase_train(card: str, dev):
    """4l: gemma3-1b trained at full width through `launch.train.train`
    (TRAIN_*: first and last loss, tokens/s, seconds a step, peak memory),
    then one forward + backward under the profiler; the bitwise resume; one
    training step a family against the CPU port.
    Returns the trained parameters (frozen) and the seconds a step."""
    t0 = time.perf_counter()

    def tlog(msg: str) -> None:
        log(f"[train] {msg} ({card})")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    (state, hist), secs = timed(lambda: train_cli.train(
        TRAIN_ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, full=True, lr=TRAIN_LR,
        log_every=TRAIN_LOG_EVERY, act_dtype=torch.bfloat16, device=dev))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    cfg = get_arch(TRAIN_ARCH)
    first, second, last = hist[0], hist[1], hist[-1]
    step_s = (last["wall_s"] - second["wall_s"]) / (last["step"] - second["step"])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(p.numel() for p in state.params.parameters())
    tlog(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab}, "
         f"{n_params} parameters (fp32 master weights, AdamW moments fp32), bf16 activations, "
         f"remat full, CE chunks of 512: {TRAIN_STEPS} steps of batch {TRAIN_BATCH} x {TRAIN_SEQ} "
         f"in {secs:.2f}s with the init ({TRAIN_STEPS * tokens / secs:.0f} tokens/s); steps "
         f"{second['step']}-{last['step']} {step_s:.4f}s a step, {tokens / step_s:.0f} tokens/s; "
         f"loss {first['loss']:.4f} at step {first['step']} -> {last['loss']:.4f} at step "
         f"{last['step']} (drop {first['loss'] - last['loss']:.4f}, at least {TRAIN_DROP}); "
         f"grad norm {first['grad_norm']:.3f} -> {last['grad_norm']:.3f}; peak device memory "
         f"{peak:.2f} GiB")
    if not last["loss"] < first["loss"] - TRAIN_DROP or not math.isfinite(last["loss"]):
        raise AssertionError(f"training did not lower the loss by {TRAIN_DROP}: {first['loss']} "
                             f"-> {last['loss']}")
    params = state.params
    del state, hist
    # where a step's time goes: one forward + backward of the trained model
    # on the next step's batch (the AdamW update not included)
    batch = PIPE.batch_for_step(cfg, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, device=dev)
    profiled(f"one forward + backward of {cfg.name}, batch {TRAIN_BATCH} x {TRAIN_SEQ}, bf16, "
             "remat full", lambda: TS.loss_and_grads(params, cfg, batch, act_dtype=torch.bfloat16),
             top=12)
    del batch
    torch.cuda.empty_cache()
    train_resume(dev, tlog)
    torch.cuda.empty_cache()
    train_families(dev, tlog)
    tlog(f"done in {time.perf_counter() - t0:.1f}s")
    return params, step_s


# ---------------------------------------------------------------------------
# phase 4m: compression, fault tolerance and expert parallelism at world size 1
# ---------------------------------------------------------------------------


def dist_compression(params, group, step_s: float, dlog) -> None:
    """One gradient of the trained gemma3-1b through `compressed_psum_mean`
    over the group: q and the scales of DIST_LEAVES bitwise the CPU port's;
    at world size 1 the mean is the dequantized gradient, bitwise, within
    half a quantization step of the gradient; its time, the bytes it
    all-reduces and their share of a 4l step; one `ErrorFeedback.compress`."""
    cfg = get_arch(TRAIN_ARCH)
    dev = params.device
    batch = PIPE.batch_for_step(cfg, TRAIN_STEPS + 1, TRAIN_BATCH, TRAIN_SEQ, device=dev)
    _, _, grads = TS.loss_and_grads(params, cfg, batch, act_dtype=torch.bfloat16)
    del batch
    for name in DIST_LEAVES:
        q, sc = COMP.quantize_int8(grads[name])
        qc, scc = COMP.quantize_int8(grads[name].cpu())
        if not (torch.equal(q.cpu(), qc) and torch.equal(sc.cpu(), scc)):
            raise AssertionError(f"quantize_int8 of {name} differs between the card and the CPU")
    n = sum(g.numel() for g in grads.values())
    blocks = sum(-(-g.numel() // 256) for g in grads.values())
    scale_bytes, q_bytes = blocks * 4, blocks * 256 * 4

    def compress_all():
        return {name: COMP.compressed_psum_mean(g, group) for name, g in grads.items()}

    secs = [timed(compress_all)[1] for _ in range(3)]
    profiled("compressed_psum_mean of the whole gradient", compress_all)
    mean = compress_all()
    worst, exact = 0.0, 0
    for name, g in grads.items():
        q, sc = COMP.quantize_int8(g)
        exact += torch.equal(mean[name], COMP.dequantize_int8(q, sc, g.shape))
        err = (COMP._blocks(mean[name], 256) - COMP._blocks(g, 256)).abs() / sc
        worst = max(worst, float(err.max()))
    del mean
    if exact != len(grads) or worst > 0.5 + 1e-4:
        raise AssertionError(f"compressed mean: {exact} of {len(grads)} leaves the dequantized "
                             f"gradient, worst error {worst} of a quantization step")
    dlog(f"compressed_psum_mean of {cfg.name}'s gradient ({n} fp32 elements, {len(grads)} "
         f"leaves, batch {TRAIN_BATCH} x {TRAIN_SEQ}) on {dist.get_backend(group)} at world size "
         f"{dist.get_world_size(group)}: " + " / ".join(f"{v * 1e3:.1f}" for v in secs)
         + f" ms (three runs); all-reduced {q_bytes} B of int32 q + {scale_bytes} B of scales = "
         f"{(q_bytes + scale_bytes) / (4 * n):.4f}x the fp32 gradient; "
         f"{min(secs) / step_s:.1%} of a 4l step ({step_s:.4f} s); q and scales of "
         f"{', '.join(DIST_LEAVES)} bitwise the CPU port's; every leaf bitwise its dequantized "
         f"int8, worst error {worst:.4f} of a quantization step (<= 0.5)")
    resid = COMP.ErrorFeedback.init(grads)
    (sent, resid), ef_s = timed(lambda: COMP.ErrorFeedback.compress(grads, resid))
    gmax = max(float(g.abs().max()) for g in grads.values())
    rmax = max(float(r.abs().max()) for r in resid.values())
    dlog(f"ErrorFeedback.compress of the same gradient: {ef_s * 1e3:.1f} ms, residual largest "
         f"magnitude {rmax:.4g} (the gradient's largest {gmax:.4g}, / 254 = {gmax / 254:.4g})")
    if rmax > gmax / 254 * (1 + 1e-4):
        raise AssertionError("an ErrorFeedback residual exceeds half a quantization step")


def _resume_model():
    cfg = truncate_units(get_arch(TRAIN_ARCH), RESUME_UNITS)

    def fresh(dev, seed: int):
        params = LM.init_params(cfg, seed=seed, device=dev)
        return TS.TrainState(params, OPT.init(dict(params.named_parameters())))

    def batch(step: int, dev):
        return PIPE.batch_for_step(cfg, step, RESUME_BATCH, RESUME_SEQ, device=dev)

    return cfg, fresh, batch


def _same_state(a, b) -> tuple[int, int]:
    """(leaves bitwise equal, leaves) over the parameters, both moments and
    the step of two train states."""
    pairs = list(zip(a.params.parameters(), b.params.parameters()))
    for name in a.opt.mu:
        pairs += [(a.opt.mu[name], b.opt.mu[name]), (a.opt.nu[name], b.opt.nu[name])]
    pairs.append((a.opt.step, b.opt.step))
    return sum(torch.equal(x, y) for x, y in pairs), len(pairs)


def dist_train_step(group, dev, dlog) -> None:
    """DIST_K steps of `make_train_step(compress_pod_grads=True,
    pod_axis=group)` bitwise DIST_K plain steps whose gradients are
    replaced by the same formula (at world size 1: dequantize(quantize(g)));
    then on to DIST_STEPS compressed steps, whose last loss must lie below
    the first."""
    cfg, fresh, batch = _resume_model()
    opt_cfg = OPT.AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=DIST_STEPS)
    compressed = TS.make_train_step(cfg, opt_cfg, act_dtype=torch.bfloat16,
                                    compress_pod_grads=True, pod_axis=group)

    def plain(state, b):
        loss, _, grads = TS.loss_and_grads(state.params, cfg, b, act_dtype=torch.bfloat16)
        grads = {name: COMP.dequantize_int8(*COMP.quantize_int8(g), g.shape)
                 for name, g in grads.items()}
        _, opt, _ = OPT.apply(opt_cfg, state.opt, dict(state.params.named_parameters()), grads)
        return TS.TrainState(state.params, opt), {"loss": loss}

    torch.use_deterministic_algorithms(True)
    try:
        runs, losses = [], []
        for fn in (compressed, plain):
            state = fresh(dev, SEED + 97)
            for step in range(DIST_K):
                state, m = fn(state, batch(step, dev))
                if fn is compressed:
                    losses.append(float(m["loss"]))
            runs.append(state)
        same, total = _same_state(*runs)
        state = runs[0]
        del runs
        t0 = time.perf_counter()
        for step in range(DIST_K, DIST_STEPS):
            state, m = compressed(state, batch(step, dev))
            losses.append(float(m["loss"]))
        steps_s = (time.perf_counter() - t0) / (DIST_STEPS - DIST_K)
    finally:
        torch.use_deterministic_algorithms(False)
    dlog(f"compressed train step, {cfg.name} ({cfg.n_layers} layers at full width, batch "
         f"{RESUME_BATCH} x {RESUME_SEQ}, bf16 activations, deterministic algorithms): {DIST_K} "
         f"steps against {DIST_K} plain steps on the quantized gradients: {same} of {total} "
         f"parameter, moment and step leaves bitwise equal; steps {DIST_K + 1}-{DIST_STEPS} "
         f"{steps_s:.4f} s a step, loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if same != total:
        raise AssertionError("the compressed train step differs from the plain one")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"compressed training did not lower the loss: {losses}")


def dist_supervisor(dev, dlog) -> None:
    """`TrainingSupervisor` over the real train step: FT_STEPS steps, a
    checkpoint every FT_SAVE_EVERY under build/, a host lost before step
    FT_KILL_AT, the restart restoring the last checkpoint; the final state
    bitwise FT_STEPS straight steps; the restart's cost."""
    cfg, fresh, batch = _resume_model()
    step_fn = TS.make_train_step(cfg, OPT.AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                                      total_steps=FT_STEPS),
                                 act_dtype=torch.bfloat16)
    ckpt = Path(__file__).resolve().parent / "build" / "dist_ft"
    shutil.rmtree(ckpt, ignore_errors=True)
    clock = [0.0]
    coord = FT.Coordinator(FT_HOSTS, heartbeat_timeout=5.0, now=lambda: clock[0])
    spent = {"save": 0.0, "restore": 0.0, "replayed": 0}
    done = set()

    def step_and_beat(state, step):
        for h in coord.alive_hosts():
            coord.heartbeat(h)
        spent["replayed"] += step in done
        done.add(step)
        return step_fn(state, batch(step, dev))[0]

    def save_fn(state, step):
        _, s = timed(lambda: CKPT.save(ckpt, step, convert.train_state_to_jax(state, cfg)))
        spent["save"] += s

    like = {}

    def restore_fn():
        def restore():
            step = CKPT.latest_step(ckpt)
            tree = CKPT.restore(ckpt, step, like["tree"])
            return convert.train_state_from_jax(tree, cfg, device=dev), step

        for h in coord.hosts.values():
            h.alive, h.last_heartbeat = True, clock[0]
        out, s = timed(restore)
        spent["restore"] += s
        return out

    def kill_host(c):
        c.hosts[2].last_heartbeat = -100.0

    torch.use_deterministic_algorithms(True)
    try:
        def straight_run():
            state = fresh(dev, SEED + 99)
            for step in range(FT_STEPS):
                state = step_fn(state, batch(step, dev))[0]
            return state

        straight, straight_s = timed(straight_run)
        like["tree"] = convert.train_state_to_jax(straight, cfg)  # the leaves' shapes
        sup = FT.TrainingSupervisor(coord, FT_SAVE_EVERY, save_fn, restore_fn)
        (state, step), sup_s = timed(lambda: sup.run(fresh(dev, SEED + 99), step_and_beat,
                                                     FT_STEPS, events={FT_KILL_AT: kill_host}))
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt, ignore_errors=True)
    same, total = _same_state(state, straight)
    step_cost = straight_s / FT_STEPS
    dlog(f"TrainingSupervisor over {FT_HOSTS} simulated hosts, {cfg.name} ({cfg.n_layers} layers "
         f"at full width, deterministic algorithms): {FT_STEPS} steps, a checkpoint every "
         f"{FT_SAVE_EVERY}, a host lost before step {FT_KILL_AT}: {sup.restarts} restart, "
         f"{spent['replayed']} steps replayed, {same} of {total} leaves bitwise the straight run "
         f"(step {int(state.opt.step)}); supervised {sup_s:.2f} s against {straight_s:.2f} s "
         f"straight; saves {spent['save']:.2f} s, the restart {spent['restore']:.2f} s restore "
         f"+ {spent['replayed'] * step_cost:.2f} s replayed = "
         f"{spent['restore'] + spent['replayed'] * step_cost:.2f} s")
    if sup.restarts != 1 or step != FT_STEPS or same != total:
        raise AssertionError("the supervised run differs from uninterrupted training")


def dist_ep(dev, dlog) -> None:
    """deepseek-moe-16b's MoE layer on the expert-parallel path (a (1, 1)
    mesh: the model group is this rank) against the dense path: outputs,
    every gradient of sum(y^2), the drop fractions; times and peak memory."""
    cfg = dataclasses.replace(get_arch(EP_ARCH), moe_capacity_factor=EP_CAPACITY)
    g = torch.Generator(dev).manual_seed(SEED + 98)
    weights = MOE.init_moe_params(g, cfg, dtype=torch.float32)
    x = torch.randn((EP_BATCH, EP_SEQ, cfg.d_model), generator=g, device=dev)
    mesh = make_debug_mesh((1, 1), device=dev.type)

    def run(ep: bool):
        params = {k: ({kk: t.clone().requires_grad_(True) for kk, t in v.items()}
                      if isinstance(v, dict) else v.clone().requires_grad_(True))
                  for k, v in weights.items()}
        xx = x.clone().requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        with use_hints(mesh) if ep else contextlib.nullcontext():
            y, aux = MOE.moe_block(params, cfg, xx)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (y**2).sum().backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        grads = {"x": xx.grad}
        for name, v in params.items():
            for sub, t in (v.items() if isinstance(v, dict) else [(None, v)]):
                grads[name if sub is None else f"{name}.{sub}"] = t.grad
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        return y.detach(), float(aux["moe_drop_frac"]), grads, (t1 - t0, t2 - t1, peak)

    run(True)  # warm-up: NCCL's first all-reduce, cuBLAS handles
    dense = run(False)
    ep = run(True)
    scale = float(dense[0].abs().max())
    out_err = float((ep[0] - dense[0]).abs().max())
    worst = {}
    for name, want in dense[2].items():
        wmax = float(want.abs().max())
        worst[name] = (float((ep[2][name] - want).abs().max()), wmax)
    bad = [n for n, (err, wmax) in worst.items() if err > EP_GRAD_TOL * max(wmax, 1.0)]
    (df, db, dp), (ef, eb, ep_peak) = dense[3], ep[3]
    dlog(f"expert-parallel MoE, {cfg.name}'s layer (d_model {cfg.d_model}, {cfg.n_experts} "
         f"experts top-{cfg.top_k}, {cfg.n_shared_experts} shared, d_expert {cfg.d_expert}, "
         f"capacity {EP_CAPACITY}), {EP_BATCH} x {EP_SEQ} tokens fp32, mesh (1, 1) on "
         f"{dist.get_backend()}: output max abs err {out_err:.3g} of {scale:.4g} (tolerance "
         f"{EP_OUT_TOL} of it); gradients of sum(y^2) max abs err / leaf max: " + ", ".join(
             f"{n} {e:.3g} / {w:.4g}" for n, (e, w) in worst.items())
         + f" (tolerance {EP_GRAD_TOL}, of the leaf max where > 1); drop fraction dense "
         f"{dense[1]} / EP {ep[1]}; forward + backward dense {df:.4f} + {db:.4f} s, EP "
         f"{ef:.4f} + {eb:.4f} s (EP / dense {(ef + eb) / (df + db):.3f}); peak above the "
         f"weights dense {dp:.2f} / EP {ep_peak:.2f} GiB")
    if out_err > EP_OUT_TOL * max(scale, 1.0) or bad or dense[1] != 0.0 or ep[1] != 0.0:
        raise AssertionError(f"the expert-parallel MoE differs from the dense path: output "
                             f"{out_err}, gradients {bad}, drops {dense[1]} / {ep[1]}")


def phase_dist(card: str, dev, params, step_s: float) -> None:
    """4m: gradient compression, the compressed train step, the supervisor's
    restart and the expert-parallel MoE on an NCCL group of world size 1
    (`launch/_group.join`; destroyed only if this phase made it)."""
    t0 = time.perf_counter()

    def dlog(msg: str) -> None:
        log(f"[dist] {msg} ({card})")

    dev, made = _group.join(dev)
    try:
        torch.cuda.empty_cache()
        dist_compression(params, dist.group.WORLD, step_s, dlog)
        torch.cuda.empty_cache()
        dist_train_step(dist.group.WORLD, dev, dlog)
        torch.cuda.empty_cache()
        dist_supervisor(dev, dlog)
        torch.cuda.empty_cache()
        dist_ep(dev, dlog)
    finally:
        if made:
            dist.destroy_process_group()
    dlog(f"done in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 4n: the production-mesh dry-run
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def mesh_override(value):
    """REPRO_TORCH_MESH_OVERRIDE set to `value` (unset for None) in the body."""
    old = os.environ.pop("REPRO_TORCH_MESH_OVERRIDE", None)
    if value is not None:
        os.environ["REPRO_TORCH_MESH_OVERRIDE"] = value
    try:
        yield
    finally:
        os.environ.pop("REPRO_TORCH_MESH_OVERRIDE", None)
        if old is not None:
            os.environ["REPRO_TORCH_MESH_OVERRIDE"] = old


def dry_grnnd(dev, rows, ylog) -> None:
    """Each GRNND cell on the card over each fake group: rank 0's round
    under `trace_stats` (the record's counts), then timed alone; after
    each cell, B1 and B2 held against their plain versions at its shapes
    (phase 2's rows): B1 on the cell's pool slice, B2 on that round's merge
    with the rank's own requests as the received ones (under a fake group
    the all-to-all moves nothing). The path's launch counts are the cells'
    alone."""
    cfg = GRNNDConfig(**DR_SPEC.GRNND_CELL_CFG)
    measure = functools.partial(kernel_row, rows)
    path: dict[str, int] = {}
    for world, override in DRY_WORLDS:
        for shape in DR_SPEC.GRNND_SHAPES:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            before = ops.launch_counts()
            with mesh_override(override), DRY.fake_group(world):
                mesh = make_production_mesh(multi_pod=world == 512, device="cuda")
                fn, (x, ids, dists) = DR_SPEC._grnnd_cell(shape, mesh, device="cuda")
                rec = DRY.trace_stats(fn, (x, ids, dists))
                _, round_s = timed(lambda: fn(x, ids, dists))
                sizes = SH.axis_sizes(mesh)
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            after = ops.launch_counts()
            for name, v in after.items():
                path[name] = path.get(name, 0) + v - before.get(name, 0)
            col, mem = rec["collectives"], rec["memory"]
            ylog(f"grnnd {shape} over {world} ranks {sizes}: all-to-all {col['all-to-all']} B "
                 f"in {col['n_all-to-all']}, all-reduce {col['all-reduce']} B in "
                 f"{col['n_all-reduce']}; arguments {mem['argument_size_bytes']} B, "
                 f"temporaries {mem['temp_size_bytes']} B, peak {peak:.2f} GiB; one rank's round "
                 f"{round_s * 1e3:.2f} ms ({rec['trace_s']}s under the counter)")
            if col["n_all-to-all"] != 3:
                raise AssertionError(f"the grnnd cell {shape} over {world} ranks: {rec}")

            n, d = x.shape
            c, r, p = ids.shape[0], cfg.r, cfg.pairs_per_vertex
            si, sj = (a.to(dev) for a in Draws(SEED, dev).shard_slot_pairs(0, 0, 0, c, r, p))
            tag = f"[grnnd,d={d},S={world}]"

            def rng_check(got, want):
                err, ties = check_rng_round(got, want, dists, si, sj)
                return err, f"; {ties} dst mismatches at near-ties"

            measure(f"rng_round{tag}", "src/repro_torch/kernels/csrc/rng_round.cu",
                    "src/repro/kernels/rng_round.py:124",
                    lambda: rng_round(x, ids, dists, si, sj),
                    lambda: ref.rng_round_ref(x, ids, dists, si, sj),
                    rng_check, unique_rows(ids) * d * 4 + c * r * 9 + c * p * 20, 3 * c * p * d,
                    None, 10, launches_of="rng_round")
            dst, src, dij, kill = rng_round(x, ids, dists, si, sj)
            own = D._filter_to_local(
                D.P.Requests(dst.reshape(-1), src.reshape(-1), dij.reshape(-1)), 0, c)
            staged_i, staged_d = D.P.group_requests(own, c, cfg.cap, drop_self=False)
            mi = torch.cat([torch.where(kill, -1, ids), staged_i], 1).contiguous()
            md = torch.cat([torch.where(kill, torch.inf, dists), staged_d], 1).contiguous()
            del dst, src, dij, kill, own, staged_i, staged_d, x
            b, w = mi.shape

            def merge_check(got, want):
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError("topr_merge differs from its plain version")
                return 0.0, "; ids and dists equal"

            measure(f"topr_merge{tag}", "src/repro_torch/kernels/csrc/topr_merge.cu",
                    "src/repro/kernels/topr_merge.py:58",
                    lambda: topr_merge(mi, md, r), lambda: ref.topr_merge_ref(mi, md, r),
                    merge_check, b * w * 8 + b * r * 8, b * w * math.log2(w), None, 10,
                    launches_of="topr_merge")
            del mi, md, ids, dists, fn
    path_counts("dryrun", path, ("rng_round", "topr_merge"), rows)


def dry_step(dev, step_s: float, ylog) -> None:
    """4l's train step (gemma3-1b at full width, batch TRAIN_BATCH x
    TRAIN_SEQ, bf16 activations, remat full, CE chunks of 512) traced on
    meta at a (1, 1) mesh, against one real step on the card: the traced
    FLOPs equal `FlopCounterMode`'s count of the real step, the argument
    bytes the real parameters', moments', step's and batch's; the
    predicted peak (arguments + the trace's temporaries) beside the
    measured one."""
    cfg = get_arch(TRAIN_ARCH)
    shape = ShapeConfig("4l", TRAIN_SEQ, TRAIN_BATCH, "train")
    with DRY.fake_group(1):
        mesh = make_debug_mesh((1, 1), device=DRY.mesh_device("cuda"))
        fn, args = DR_SPEC.make_cell(TRAIN_ARCH, shape, mesh)
        rec = DRY.trace_stats(fn, args)
        del fn, args
    from torch.utils.flop_counter import FlopCounterMode

    torch.cuda.empty_cache()
    params = LM.init_params(cfg, seed=SEED, device=dev)
    state = TS.TrainState(params, OPT.init(dict(params.named_parameters())))
    batch = PIPE.batch_for_step(cfg, 0, TRAIN_BATCH, TRAIN_SEQ, device=dev)
    step = TS.make_train_step(cfg, OPT.AdamWConfig(lr=TRAIN_LR), act_dtype=torch.bfloat16)
    real_bytes = sum(t.nbytes for t in (*params.parameters(), *state.opt.mu.values(),
                                        *state.opt.nu.values(), state.opt.step,
                                        *batch.values()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    counter = FlopCounterMode(display=False)
    with counter:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    flops = counter.get_total_flops()
    mem = rec["memory"]
    predicted = mem["argument_size_bytes"] + mem["temp_size_bytes"]
    ylog(f"4l's step traced on meta at (1, 1) ({rec['trace_s']}s, {rec['hlo_ops']} local ops): "
         f"{rec['cost']['flops']:.0f} FLOPs against FlopCounterMode's {flops} of one real step; "
         f"arguments {mem['argument_size_bytes']} B against the real step's {real_bytes} B; "
         f"predicted peak {predicted / 2**30:.2f} GiB (arguments + temporaries "
         f"{mem['temp_size_bytes'] / 2**30:.2f}) against the measured "
         f"{peak / 2**30:.2f} GiB; 4l's step {step_s:.4f}s: {flops / step_s / 1e12:.1f} TFLOP/s, "
         f"{flops / step_s / PEAK_FLOPS_BF16:.1%} of the bf16 peak")
    del state, params, batch
    if rec["cost"]["flops"] != flops or mem["argument_size_bytes"] != real_bytes:
        raise AssertionError("the dry-run's count of 4l's step differs from the real step's")


def _cost_line(cost: dict, col: dict) -> str:
    return (f"{cost['flops']:.4g} FLOPs, {cost['bytes_accessed']:.4g} B accessed; collectives "
            + ", ".join(f"{c} {col[c] / 2**30:.3f} GiB in {col['n_' + c]:.0f}"
                        for c in DRY.COLLECTIVES if col["n_" + c]))


def dry_cells(ylog) -> None:
    """The production cells on the 16 x 16 fake group of CUDA ranks:
    `run_cell` for the whole-depth ones (with their probes where asked, which
    must equal the whole trace), `probe_cost` for the cut ones."""
    with mesh_override(None):
        for arch, shape, whole, probes in DRY_CELLS:
            kind = DR_SPEC.SHAPES[shape].kind
            policy = DR_SPEC.parallelism_policy(get_arch(arch), DR_SPEC.SHAPES[shape],
                                                {"data": 16, "model": 16})
            where = f"{arch} {shape} on 16 x 16 (cuda ranks, {policy if kind == 'train' else kind})"
            if whole:
                rec = DRY.run_cell(arch, shape, "single", cost_probes=probes)
                if rec["status"] != "ok":
                    raise AssertionError(f"{arch} {shape}: {rec}")
                mem = rec["memory"]
                ylog(f"{where}: traced whole in {rec['trace_s']}s; per rank: arguments "
                     f"{mem['argument_size_bytes'] / 2**30:.3f} GiB, temporaries "
                     f"{mem['temp_size_bytes'] / 2**30:.3f} GiB, {rec['hlo_ops']} local ops, "
                     + _cost_line(rec["cost"], rec["collectives"]))
                if probes:
                    ylog(f"{where}: its probes, traced in {rec['probe_compile_s']}s: "
                         + _cost_line(rec["cost_probes"], rec["collectives_probes"]))
                    if rec["cost_probes"] != rec["cost"] \
                            or rec["collectives_probes"] != rec["collectives"]:
                        raise AssertionError(f"{arch} {shape}: the probes differ from the "
                                             "whole-depth trace")
            else:
                with DRY.fake_group(256):
                    mesh = make_production_mesh(device=DRY.mesh_device("cuda"))
                    ex, secs = DRY.probe_cost(arch, shape, mesh)
                rec = {"arch": arch, "shape": shape, "mesh": "single", "status": "ok",
                       "probe_compile_s": secs, "cost_probes": ex["cost"],
                       "collectives_probes": ex["collectives"]}
                ylog(f"{where}: cut to its probes, traced in {secs}s; per rank: "
                     + _cost_line(ex["cost"], ex["collectives"]))
            log(json.dumps({"dryrun_record": rec}))


def phase_dryrun(card: str, dev, rows, step_s: float) -> None:
    """4n: the production-mesh dry-run (`launch/dryrun.py`)."""
    t0 = time.perf_counter()

    def ylog(msg: str) -> None:
        log(f"[dryrun] {msg} ({card})")

    dry_grnnd(dev, rows, ylog)
    torch.cuda.empty_cache()
    dry_step(dev, step_s, ylog)
    torch.cuda.empty_cache()
    dry_cells(ylog)
    ylog(f"done in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 5: where the time goes (after the main path's counts are read)
# ---------------------------------------------------------------------------


def _device_us(evt) -> float:
    """Device time of a kernel row (operator rows repeat their kernels' time)."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    return float(evt.self_device_time_total)


def profiled(label: str, fn, top: int = 8) -> list:
    """Log the wall time, device-busy share and top device-time ops of one
    call; returns the profiler's rows that took device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if _device_us(e) > 0]
    busy = sum(_device_us(e) for e in events) / 1e6
    if not events:
        log(f"[profile] {label}: {wall:.3f}s wall; the profiler saw no device time")
        return events
    log(f"[profile] {label}: {wall:.3f}s wall, device busy {busy:.3f}s ({busy / wall:.1%})")
    for e in sorted(events, key=_device_us, reverse=True)[:top]:
        log(f"[profile]   {_device_us(e) / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:90]}")
    return events


def phase_profile(x, queries, pool, truth, cfg, idx) -> None:
    t0 = time.perf_counter()
    dev = x.device
    draws = Draws(SEED + 3, dev)
    profiled("one propagation round, n=1M", lambda: update_round(x, pool, draws, cfg, 0, 0))
    # rng_round on the built pool, whose rows come from device memory, and
    # with every id folded into 20,000 rows (10 MB, held in L2): what the
    # kernel takes when no row comes from device memory
    n, r, p = x.shape[0], cfg.r, cfg.pairs_per_vertex
    si, sj = (a.to(dev) for a in draws.slot_pairs(0, 0, None, n, r, p))
    folded = torch.where(pool.ids >= 0, pool.ids % 20_000, -1)
    ms = [
        cuda_ms(lambda ids=ids: rng_round(x, ids, pool.dists, si, sj), 10)
        for ids in (pool.ids, folded, folded, pool.ids)
    ]
    log(
        "[profile] rng_round on the built pool / folded into 20,000 L2-resident rows / "
        "folded / built: " + " / ".join(f"{v:.3f}" for v in ms) + " ms"
    )
    del si, sj, folded
    events = profiled(
        "search ef=64 hashed, 10,000 queries",
        lambda: search(x, pool.ids, queries, k=10, ef=64, visited="hashed", device=dev),
    )
    for label, key in (("search_expand (B3)", "search_expand"), ("visited_insert", "visited_insert")):
        hits = [e for e in events if key in e.key]
        log(
            f"[profile] {label} over that search: "
            f"{sum(_device_us(e) for e in hits) / 1e3:.2f} ms device time in "
            f"{sum(e.count for e in hits)} launches"
        )
    # the same search with the exact (Q, N) mask: no table, the same n_expanded
    profiled(
        "search ef=64 dense, 10,000 queries",
        lambda: search(x, pool.ids, queries, k=10, ef=64, visited="dense", device=dev),
    )
    # the dynamic index after compaction (900,000 live): one more insert
    # batch of 10,000 (rows near the corpus, new labels) and one search
    g = torch.Generator(dev).manual_seed(SEED + 23)
    extra = synthetic.queries_from(g, x, DYN_BATCH)
    profiled("dynamic insert of 10,000 (int8)", lambda: idx.insert(extra))
    profiled(
        "dynamic search ef=64 hashed + rescore, 10,000 queries",
        lambda: idx.search(queries, k=10, ef=64, visited="hashed"),
    )
    # does the hashed table's default cap (512 slots) cost recall at n = 1M?
    for visited, cap in (("hashed", 8192), ("dense", None)):
        res, s = timed(
            lambda: search(
                x, pool.ids, queries, k=10, ef=64, visited=visited, visited_cap=cap, device=dev
            )
        )
        log(
            f"[profile] search ef=64 {visited} cap={cap}: {s:.2f}s, "
            f"mean n_expanded {float(res.n_expanded.float().mean()):.1f}, "
            f"recall@10 {recall_at_k(res.ids, truth):.4f}"
        )
    # graph quality: the share of 1,000 vertices' true 10-NN found in their pools
    g = torch.Generator(dev).manual_seed(SEED + 6)
    sample = torch.randint(0, x.shape[0], (1000,), generator=g, device=dev)
    knn = brute_force_knn(x, x[sample], 11, device=dev)[:, 1:]  # drop the vertex itself
    log(f"[profile] graph 10-NN recall of the pools: {recall_at_k(pool.ids[sample], knn):.4f}")
    log(f"[profile] done in {time.perf_counter() - t0:.1f}s")


def main() -> None:
    ap = argparse.ArgumentParser(description="Every phase on one card; the last line is the result.")
    ap.add_argument("--knn-states", metavar="PATH",
                    help="save phase 4i's witness states (npz) for tests/_knn_witness.py")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this script needs a card")
    t0 = time.perf_counter()
    card = phase_device()
    dev = torch.device("cuda", 0)
    cfg = SIFT1M.build
    g = torch.Generator(dev).manual_seed(SEED)
    x = synthetic.make_preset(g, "sift-like", SIFT1M.n)
    queries = synthetic.queries_from(g, x, SIFT1M.n_queries)
    rows = phase_kernels(x, queries, Draws(SEED + 1, dev), cfg)
    torch.cuda.empty_cache()
    parity = phase_parity(dev, cfg)
    torch.cuda.empty_cache()
    pool, truth, recalls, build_s, results = phase_main(x, queries, cfg, rows)
    phase_sorted(x, queries, cfg, truth, recalls[64], build_s)
    torch.cuda.empty_cache()
    idx = phase_dynamic(x, queries, cfg, recalls[64], rows)
    torch.cuda.empty_cache()
    phase_bf16(x, queries, cfg, rows)
    torch.cuda.empty_cache()
    filtered = phase_filtered(x, queries, pool, rows)
    torch.cuda.empty_cache()
    phase_tiered(x, queries, cfg, rows)
    torch.cuda.empty_cache()
    phase_corpus(x, queries, cfg, pool, truth, results[64], filtered, idx, rows)
    torch.cuda.empty_cache()
    phase_nccl(cfg, parity)
    torch.cuda.empty_cache()
    phase_profile(x, queries, pool, truth, cfg, idx)
    torch.cuda.empty_cache()
    phase_serving(x, queries, pool, truth, filtered, idx, card)
    del x, queries, pool, truth, results, filtered, idx, parity
    torch.cuda.empty_cache()
    phase_knn(KNN_4I, card, rows, dev, args.knn_states)
    torch.cuda.empty_cache()
    phase_knn(KNN_4J, card, rows, dev)
    torch.cuda.empty_cache()
    phase_families(card, rows, dev)
    torch.cuda.empty_cache()
    trained, step_s = phase_train(card, dev)
    phase_knn(KNN_4L, card, rows, dev, params=trained)
    torch.cuda.empty_cache()
    phase_dist(card, dev, trained, step_s)
    del trained
    torch.cuda.empty_cache()
    phase_dryrun(card, dev, rows, step_s)
    log(f"[total] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": rows}))
    kind = torch.cuda.get_device_name(0)
    device = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
