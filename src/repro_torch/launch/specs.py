"""Abstract arguments and step functions for the production-mesh dry-run.

A port of the JAX package's `launch/specs.py`, name for name. Where the
reference builds `ShapeDtypeStruct`s with `NamedSharding`s, the port builds
DTensors over `meta` tensors, placed by `distributed/sharding`'s specs
(`sharding.with_shardings`): no parameter or activation is allocated. Each
(arch x shape) cell gives

  * its arguments, each rank's block of every leaf, and
  * the step function to trace: the train step, prefill or one decode
    step, run under the mesh's hints (`distributed/hints.use_hints`).

The GRNND build is the pseudo-arch "grnnd-ann": one rank's build round,
run for real with real tensors (`_grnnd_cell`).
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import get_arch
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, truncate_units
from repro_torch.distributed import hints as H
from repro_torch.distributed import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS

PARAM_DTYPE = torch.float32
ACT_DTYPE = torch.bfloat16
CACHE_DTYPE = torch.bfloat16


def _sizes(mesh) -> dict[str, int]:
    """{axis: size} of a `DeviceMesh`, or of a mapping given as it is."""
    return SH.axis_sizes(mesh) if isinstance(mesh, DeviceMesh) else dict(mesh)


def _with_hints(fn: Callable, mesh: DeviceMesh, fsdp: bool = False) -> Callable:
    """Run `fn` under the mesh's hints: the model blocks take their
    explicitly sharded paths (the expert-parallel MoE, the per-layer FSDP
    gather)."""
    def wrapped(*args):
        with H.use_hints(mesh, fsdp=fsdp):
            return fn(*args)
    return wrapped


def parallelism_policy(cfg: ArchConfig, shape: ShapeConfig,
                       mesh: DeviceMesh | Mapping[str, int]) -> str:
    """"dp_only" (replicate parameters, the model axis as more data
    parallelism), "tp" (parameters over the model axis), "zero1" (and the
    AdamW moments over the data axes too) or "fsdp" (and the parameters
    too). Reads only the axis sizes: `mesh` is a `DeviceMesh` or an
    {axis: size} mapping.

    Replicate when the model is under 1B parameters and the global batch
    splits over every rank. Otherwise, with fp32 parameters and AdamW at
    12 bytes a parameter: past 12 GB a rank under TP alone, ZeRO-1; when the
    fp32 parameters alone pass it, FSDP."""
    sizes = _sizes(mesh)
    n_chips = 1
    for v in sizes.values():
        n_chips *= v
    if cfg.param_count() < 1e9 and shape.global_batch % n_chips == 0:
        return "dp_only"
    model_par = sizes.get("model", 1)
    p = cfg.param_count()
    if p * 12 / model_par > 12e9:
        if p * 4 / model_par > 12e9:
            return "fsdp"
        return "zero1"
    return "tp"


def abstract_params(cfg: ArchConfig, mesh: DeviceMesh, tp: bool = True, fsdp: bool = False):
    """`LMParams` on `meta` (fp32) with DTensor parameters placed by the
    parameter rules."""
    params = T.init_params(cfg, dtype=PARAM_DTYPE, device="meta")
    specs = SH.param_shardings(_sizes(mesh), params, tp=tp, fsdp=fsdp)
    return SH.with_shardings(params, specs, mesh)


def abstract_opt_state(cfg: ArchConfig, mesh: DeviceMesh, params_abs, tp: bool = True,
                       fsdp: bool = False) -> O.AdamWState:
    """AdamW's state for `params_abs` on `meta`, placed by the
    optimizer-state rules (which may shard over more axes than the
    parameters)."""
    shapes = {name: torch.empty(p.shape, dtype=p.dtype, device="meta")
              for name, p in params_abs.named_parameters()}
    state = O.init(shapes)
    return SH.with_shardings(state, SH.opt_state_shardings(_sizes(mesh), state, tp=tp, fsdp=fsdp),
                             mesh)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh: DeviceMesh, batch_axes=None) -> dict:
    """The batch of `shape`, per modality, on `meta`, placed by the batch
    rules (over `batch_axes` when given)."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if cfg.modality == "audio_tokens":
        shapes = {"tokens": meta((b, s, cfg.n_codebooks), torch.int32)}
    elif cfg.modality == "vision_text":
        shapes = {"tokens": meta((b, s - cfg.vision_tokens), torch.int32),
                  "patch_embeds": meta((b, cfg.vision_tokens, cfg.vision_dim), ACT_DTYPE)}
    else:
        shapes = {"tokens": meta((b, s), torch.int32)}
    return SH.with_shardings(shapes, SH.batch_shardings(_sizes(mesh), shapes, batch_axes=batch_axes),
                             mesh)


def cache_specs(cfg: ArchConfig, batch: int, s_max: int, mesh: DeviceMesh) -> list[dict]:
    """`transformer.make_cache`'s caches (bf16 KV, fp32 SSM state) on
    `meta`, placed by the cache rules."""
    caches = T.make_cache(cfg, batch, s_max, dtype=CACHE_DTYPE, device="meta")
    return SH.with_shardings(caches, SH.cache_shardings(_sizes(mesh), caches), mesh)


def token_specs(cfg: ArchConfig, b: int, mesh: DeviceMesh):
    """One decode step's tokens (B,) or (B, ncb) and positions (B,), int32
    on `meta`, over the data axes when B > 1 splits over them."""
    sizes = _sizes(mesh)
    daxes = SH.data_axes(sizes)
    tok_shape = (b, cfg.n_codebooks) if cfg.modality == "audio_tokens" else (b,)
    spec = (daxes,) if b % SH._axsize(sizes, daxes) == 0 and b > 1 else ()
    tok = torch.empty(tok_shape, dtype=torch.int32, device="meta")
    pos = torch.empty((b,), dtype=torch.int32, device="meta")
    return SH.with_shardings(tok, spec, mesh), SH.with_shardings(pos, spec, mesh)


# ---------------------------------------------------------------------------
# step functions per shape kind
# ---------------------------------------------------------------------------


def make_cell(arch_name: str, shape_name: str | ShapeConfig, mesh: DeviceMesh,
              ce_chunk: int = 512, cost_probe: int = 0, cfg_override: ArchConfig | None = None,
              remat_policy: str = "full", device: str = "cuda") -> tuple[Callable, tuple]:
    """(fn, arguments) of one dry-run cell; `shape_name` names one of
    `SHAPES` or is a `ShapeConfig`.

    cost_probe=k > 0 truncates the arch to k pattern units. The CE keeps
    the whole cell's chunks: the reference's probes take it in one chunk
    (and unroll the layer scans) because XLA counts a scanned body once,
    and the port has no scan to undercount; one chunk would also place the
    logits otherwise than the whole cell does. `device` is where the GRNND
    cell runs; the LM cells are on `meta`."""
    if arch_name == "grnnd-ann":
        return _grnnd_cell(shape_name, mesh, device=device)

    cfg = cfg_override if cfg_override is not None else get_arch(arch_name)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    # the whole model's policy, also for its probes (the reference takes the
    # truncated model's, which can differ: qwen3-moe's 1-unit probe is "tp")
    policy = parallelism_policy(cfg, shape, mesh)
    if cost_probe:
        cfg = truncate_units(cfg, cost_probe)

    if shape.kind == "train":
        if policy == "dp_only":
            all_axes = tuple(a for a in ("pod", "data", "model") if a in mesh.mesh_dim_names)
            params_abs = abstract_params(cfg, mesh, tp=False)
            opt_abs = abstract_opt_state(cfg, mesh, params_abs, tp=False)
            batch_abs = batch_specs(cfg, shape, mesh, batch_axes=all_axes)
        elif policy == "fsdp":
            params_abs = abstract_params(cfg, mesh, fsdp=True)
            opt_abs = abstract_opt_state(cfg, mesh, params_abs, fsdp=True)
            batch_abs = batch_specs(cfg, shape, mesh)
        elif policy == "zero1":
            # parameters stay TP-resident; only the AdamW moments shard over data
            params_abs = abstract_params(cfg, mesh)
            opt_abs = abstract_opt_state(cfg, mesh, params_abs, fsdp=True)
            batch_abs = batch_specs(cfg, shape, mesh)
        else:
            params_abs = abstract_params(cfg, mesh)
            opt_abs = abstract_opt_state(cfg, mesh, params_abs)
            batch_abs = batch_specs(cfg, shape, mesh)
        state_abs = TS.TrainState(params_abs, opt_abs)
        step = TS.make_train_step(cfg, O.AdamWConfig(), act_dtype=ACT_DTYPE, ce_chunk=ce_chunk,
                                  remat_policy=remat_policy)
        return _with_hints(step, mesh, fsdp=policy == "fsdp"), (state_abs, batch_abs)

    params_abs = abstract_params(cfg, mesh)
    if shape.kind == "prefill":
        batch_abs = batch_specs(cfg, shape, mesh)

        def prefill_step(params, batch):
            logits, caches, _ = T.prefill(params, cfg, batch, act_dtype=ACT_DTYPE)
            return logits, caches

        return _with_hints(prefill_step, mesh), (params_abs, batch_abs)

    # decode: one new token against a seq_len cache
    b, s = shape.global_batch, shape.seq_len
    caches_abs = cache_specs(cfg, b, s, mesh)
    tok_abs, pos_abs = token_specs(cfg, b, mesh)

    def decode(params, caches, tokens, pos):
        return T.decode_step(params, cfg, caches, tokens, pos, act_dtype=ACT_DTYPE)

    return _with_hints(decode, mesh), (params_abs, caches_abs, tok_abs, pos_abs)


# ---------------------------------------------------------------------------
# the paper's own technique on the production mesh
# ---------------------------------------------------------------------------

GRNND_SHAPES = {
    "build_1m_d128": dict(n=1_048_576, d=128),
    "build_1m_d960": dict(n=1_048_576, d=960),
}

# the reference cell's round: one of T1 x T2 = 4 x 6, 48 pairs a vertex
GRNND_CELL_CFG = dict(s=24, r=48, t1=4, t2=6, pairs_per_vertex=48, chunk_size=None)


def _grnnd_cell(shape_name: str, mesh: DeviceMesh, *, device: str = "cuda", d: int | None = None):
    """One rank's vertex-sharded build round over the mesh's ranks (the
    vertices shard over every mesh axis: GRNND has no tensor-parallel
    dimension), with the reference's round: `core/distributed._round_local`
    with `comm="a2a"`, whose outputs stay vertex-sharded (no trailing
    all-gather of the global pool).

    Returns (round_fn, (x, ids, dists)): x (n, d) fp32 replicated, this
    rank's (n / ranks, R) pool slice of random ids and their true squared
    distances, drawn from seed 0 on `device`. `d` replaces the shape's
    width (the CPU tests' d = 8: the exchange's bytes do not depend on it).
    Under a fake group the all-to-all moves no data, so the received
    buckets hold whatever their memory held: the round's outputs are not
    meaningful, its counts, bytes and times are."""
    from repro_torch import device as _device
    from repro_torch.core import distributed as D
    from repro_torch.core.draws import Draws
    from repro_torch.core.grnnd import GRNNDConfig
    from repro_torch.launch import _group

    spec = GRNND_SHAPES[shape_name]
    n, d = spec["n"], d or spec["d"]
    cfg = GRNNDConfig(**GRNND_CELL_CFG)
    dev = _device.resolve(device)
    group = _group.first_ranks(mesh.size())
    rank, world = D._rank_world(group)
    n_loc = n // world
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn((n, d), generator=gen, device=dev)
    ids = torch.randint(0, n, (n_loc, cfg.r), generator=gen, device=dev, dtype=torch.int32)
    dists = torch.empty((n_loc, cfg.r), device=dev)
    for lo in range(0, n_loc, 8192):  # true distances, a block of rows at a time
        blk = ids[lo : lo + 8192].long()
        rows = x[rank * n_loc + lo : rank * n_loc + lo + blk.shape[0], None]
        dists[lo : lo + blk.shape[0]] = (x[blk] - rows).square().sum(-1)
    draws = Draws(0, dev)

    def round_fn(x, ids, dists):
        out_ids, out_dists, _ = D._round_local(x, ids, dists, draws, 0, 0, cfg, group, "a2a")
        return out_ids, out_dists

    return round_fn, (x, ids, dists)


def cell_is_applicable(arch_name: str, shape_name: str) -> tuple[bool, str]:
    """(runnable, the reason when skipped), as the reference decides: the
    GRNND cells take their own shapes; long_500k needs a sub-quadratic
    stack."""
    if arch_name == "grnnd-ann":
        return shape_name in GRNND_SHAPES, "grnnd shapes only"
    cfg = get_arch(arch_name)
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention stack: no sub-quadratic "
                       "structure for 524k decode (DESIGN.md §5)")
    return True, ""
