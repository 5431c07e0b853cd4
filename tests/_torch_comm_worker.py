"""One rank of the port's multi-rank tests on gloo.

    python _torch_comm_worker.py SUITE RANK WORLD INIT_FILE OUT_DIR

Joins a gloo group through `file://INIT_FILE`, runs one suite and writes
its arrays to `OUT_DIR/rank<R>.npz` (and what is not an array to
`OUT_DIR/rank<R>.json`); the tests hold them against numpy formulas, the
port's single-process paths and the JAX package. Imports torch and
repro_torch only. Suites:

  * compression: `compressed_psum_mean` on each case of
    `_torch_gloo.COMP_CASES`; at world 2 also one compressed train step of
    reduced gemma3-1b (each rank its own batch), with the uncompressed
    gradients the step averaged;
  * moe: the expert-parallel `moe_block` on each (data, model) mesh of
    `MOE_MESHES[world]` and each variant: this rank's output rows, the
    gradients of sum(y^2) and the drop fraction; `_permute_ffn` with this
    rank's experts at two capacities, and its routing inputs;
  * mesh: `sharding.placements` through `distribute_tensor` on (2, 2) and
    (1, 2, 2) meshes, and `make_production_mesh` under the override;
  * fsdp: reduced `FSDP_ARCH`'s loss and gradients and one train step
    under `use_hints(mesh, fsdp=True)` on a (2, 2) mesh, the parameters and
    AdamW moments placed by the FSDP specs (`sharding.with_shardings`), the
    batch over the data axis; the gradients, the stepped parameters and
    the moments gathered whole. Then the same loss and gradients (without
    the load-balance term) of each `FSDP_CASES` config, with this rank's
    load-balance sum; and one decode step of reduced `FSDP_ARCH` under
    `use_hints(mesh)`, the parameters placed by the TP specs and the
    prefilled cache by the cache rules, with its logits and the written
    cache gathered whole.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from _torch_gloo import (COMP_CASES, DECODE_POS, DECODE_SMAX, FSDP_ARCH, FSDP_BATCH, FSDP_CASES,
                         FSDP_MESH, FSDP_SEQ, MOE_CAPACITY, MOE_MESHES, MOE_VARIANTS,
                         PERMUTE_CAPACITY, PLACEMENTS, STEP_ARCH, STEP_BATCH, STEP_OPT, STEP_SEQ,
                         comp_input, fsdp_case_cfg, mesh_name, moe_cfg_kwargs, moe_x)
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ArchConfig
from repro_torch.data import pipeline as PIPE
from repro_torch.distributed import hints as H
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.compression import compressed_psum_mean
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS


def compression(rank: int, world: int) -> tuple[dict, dict]:
    arrays = {}
    for case, (_, block) in COMP_CASES.items():
        x = torch.from_numpy(comp_input(case, rank))
        arrays[f"psum/{case}"] = compressed_psum_mean(x, block=block).numpy()
    if world == 2:
        cfg = reduced(get_arch(STEP_ARCH))
        params = T.init_params(cfg, seed=0, device="cpu")
        batch = PIPE.batch_for_step(cfg, rank, STEP_BATCH, STEP_SEQ, device="cpu")
        _, _, grads = TS.loss_and_grads(params, cfg, batch, act_dtype=torch.float32)
        step = TS.make_train_step(cfg, O.AdamWConfig(**STEP_OPT), act_dtype=torch.float32,
                                  compress_pod_grads=True, pod_axis=dist.group.WORLD)
        state, _ = step(TS.TrainState(params, O.init(dict(params.named_parameters()))), batch)
        for name, p in state.params.named_parameters():
            arrays[f"grad/{name}"] = grads[name].numpy()
            arrays[f"param/{name}"] = p.numpy()
            arrays[f"mu/{name}"] = state.opt.mu[name].numpy()
            arrays[f"nu/{name}"] = state.opt.nu[name].numpy()
        arrays["step"] = state.opt.step.numpy()
    return arrays, {}


def _local_params(full: dict, e0: int, e_loc: int) -> dict:
    """The router and shared experts whole, the experts [e0, e0 + e_loc),
    each a fresh leaf that takes gradients."""
    out = {}
    for name, v in full.items():
        if isinstance(v, dict):
            out[name] = {k: t.clone().requires_grad_(True) for k, t in v.items()}
        elif name == "router":
            out[name] = v.clone().requires_grad_(True)
        else:
            out[name] = v[e0 : e0 + e_loc].clone().requires_grad_(True)
    return out


def moe(rank: int, world: int) -> tuple[dict, dict]:
    arrays = {}
    xg = moe_x()
    for shape in MOE_MESHES[world]:
        mesh = make_debug_mesh(shape, device="cpu")
        d_rank, m_rank = mesh.get_coordinate()
        n_data, n_ep = shape
        rows = xg.shape[0] // n_data
        arrays[f"{mesh_name(shape)}/coord"] = np.asarray([d_rank, m_rank])
        for variant in MOE_VARIANTS:
            key = f"{mesh_name(shape)}/{variant}"
            cfg = ArchConfig(**moe_cfg_kwargs(variant, MOE_CAPACITY))
            full = M.init_moe_params(torch.Generator().manual_seed(0), cfg)
            e_loc = cfg.n_experts // n_ep
            params = _local_params(full, m_rank * e_loc, e_loc)
            x = torch.from_numpy(xg[d_rank * rows : (d_rank + 1) * rows]).requires_grad_(True)
            with H.use_hints(mesh):
                y, aux = M.moe_block(params, cfg, x)
            (y**2).sum().backward()
            arrays[f"{key}/y"] = y.detach().numpy()
            arrays[f"{key}/drop"] = aux["moe_drop_frac"].numpy()
            arrays[f"{key}/lb"] = aux["moe_lb_loss"].detach().numpy()
            arrays[f"{key}/grad/x"] = x.grad.numpy()
            for name, v in params.items():
                for sub, t in (v.items() if isinstance(v, dict) else [(None, v)]):
                    leaf = name if sub is None else f"{name}.{sub}"
                    arrays[f"{key}/grad/{leaf}"] = t.grad.numpy()
            # _permute_ffn alone on this rank's experts, with and without drops
            with torch.no_grad():
                xt = x.detach().reshape(-1, cfg.d_model)
                probs = torch.softmax(xt @ full["router"], dim=-1)
                w, idx = torch.topk(probs, cfg.top_k, dim=-1)
                w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
                arrays[f"{key}/w"], arrays[f"{key}/idx"] = w.numpy(), idx.numpy()
                for cap in (MOE_CAPACITY, PERMUTE_CAPACITY):
                    y_p, drop_p = M._permute_ffn(
                        dataclasses.replace(cfg, moe_capacity_factor=cap), xt, w, idx,
                        e_local=e_loc, e_offset=m_rank * e_loc,
                        wi_gate=params["wi_gate"], wi_up=params["wi_up"], wo=params["wo"])
                    arrays[f"{key}/permute{cap}/y"] = y_p.numpy()
                    arrays[f"{key}/permute{cap}/drop"] = drop_p.numpy()
    return arrays, {}


def mesh(rank: int, world: int) -> tuple[dict, dict]:
    from torch.distributed.tensor import distribute_tensor

    arrays, info = {}, {}
    meshes = {}
    for i, (shape, axes, spec, tshape) in enumerate(PLACEMENTS):
        if (shape, axes) not in meshes:
            meshes[shape, axes] = make_debug_mesh(shape, axes, device="cpu")
        m = meshes[shape, axes]
        arrays[f"coord/{i}"] = np.asarray(m.get_coordinate())
        full = torch.arange(int(np.prod(tshape)), dtype=torch.float32).reshape(tshape)
        local = distribute_tensor(full, m, SH.placements(spec, m)).to_local()
        arrays[f"local/{i}"] = local.numpy()
    for override in ("2,2", "1,2,2", "1,2"):
        os.environ["REPRO_TORCH_MESH_OVERRIDE"] = override
        m = make_production_mesh(device="cpu")
        info[override] = [list(m.mesh_dim_names), list(m.shape), m.get_coordinate()]
    del os.environ["REPRO_TORCH_MESH_OVERRIDE"]
    return arrays, info


def _placed(cfg, mesh, fsdp: bool):
    """Seed 0's parameters and step 0's batch, placed by the specs."""
    sizes = SH.axis_sizes(mesh)
    params = T.init_params(cfg, seed=0, device="cpu")
    params = SH.with_shardings(params, SH.param_shardings(sizes, params, fsdp=fsdp), mesh)
    batch = PIPE.batch_for_step(cfg, 0, FSDP_BATCH, FSDP_SEQ, device="cpu")
    return params, SH.with_shardings(batch, SH.batch_shardings(sizes, batch), mesh)


def _local(v: torch.Tensor) -> np.ndarray:
    return (v.to_local() if isinstance(v, DTensor) else v).detach().numpy()


def fsdp(rank: int, world: int) -> tuple[dict, dict]:
    cfg = reduced(get_arch(FSDP_ARCH))
    mesh = make_debug_mesh(FSDP_MESH, device="cpu")
    sizes = SH.axis_sizes(mesh)
    params, batch = _placed(cfg, mesh, fsdp=True)
    arrays, info = {}, {}
    with H.use_hints(mesh, fsdp=True):
        loss, _, grads = TS.loss_and_grads(params, cfg, batch, act_dtype=torch.float32)
        opt = O.init({name: p.full_tensor() for name, p in params.named_parameters()})
        opt = SH.with_shardings(opt, SH.opt_state_shardings(sizes, opt, fsdp=True), mesh)
        step = TS.make_train_step(cfg, O.AdamWConfig(**STEP_OPT), act_dtype=torch.float32)
        state, metrics = step(TS.TrainState(params, opt), batch)
    arrays["loss"] = loss.full_tensor().numpy()
    arrays["step_loss"] = metrics["loss"].full_tensor().numpy()
    arrays["grad_norm"] = metrics["grad_norm"].full_tensor().numpy()
    for name, g in grads.items():
        arrays[f"grad/{name}"] = g.full_tensor().numpy()
    for name, p in state.params.named_parameters():
        info[name] = [str(pl) for pl in p.placements]
        arrays[f"param/{name}"] = p.full_tensor().numpy()
        arrays[f"mu/{name}"] = state.opt.mu[name].full_tensor().numpy()
        arrays[f"nu/{name}"] = state.opt.nu[name].full_tensor().numpy()
    arrays["coord"] = np.asarray(mesh.get_coordinate())

    for case in FSDP_CASES:
        ccfg = fsdp_case_cfg(case)
        cparams, cbatch = _placed(ccfg, mesh, fsdp=True)
        with H.use_hints(mesh, fsdp=True):
            loss, aux, grads = TS.loss_and_grads(cparams, ccfg, cbatch, act_dtype=torch.float32,
                                                 aux_weight=0.0)
        arrays[f"{case}/loss"] = loss.full_tensor().numpy()
        arrays[f"{case}/moe_aux"] = _local(aux["moe_aux"])
        for name, g in grads.items():
            arrays[f"{case}/grad/{name}"] = g.full_tensor().numpy()

    # one decode step on a prefilled cache
    dparams = T.init_params(cfg, seed=0, device="cpu")
    prompt = PIPE.batch_for_step(cfg, 0, FSDP_BATCH, FSDP_SEQ, device="cpu")
    with torch.no_grad():
        _, caches, _ = T.prefill(dparams, cfg, prompt, s_max=DECODE_SMAX, act_dtype=torch.float32)
    dparams = SH.with_shardings(dparams, SH.param_shardings(sizes, dparams), mesh)
    caches = SH.with_shardings(caches, SH.cache_shardings(sizes, caches), mesh)
    tokens = prompt["tokens"][:, -1].contiguous()
    pos = torch.tensor(DECODE_POS, dtype=torch.int32)
    tokens, pos = (SH.with_shardings(t, (SH.data_axes(sizes),), mesh) for t in (tokens, pos))
    with H.use_hints(mesh), torch.no_grad():
        logits, caches = T.decode_step(dparams, cfg, caches, tokens, pos, act_dtype=torch.float32)
    arrays["decode/logits"] = logits.full_tensor().numpy()
    for i, cache in enumerate(caches):
        info[f"decode/cache{i}"] = {k: [pl.dim if isinstance(pl, Shard) else None
                                        for pl in v.placements] for k, v in cache.items()}
        for k, v in cache.items():
            arrays[f"decode/cache{i}/{k}"] = v.full_tensor().numpy()
    return arrays, info


SUITES = {"compression": compression, "moe": moe, "mesh": mesh, "fsdp": fsdp}


def main() -> None:
    suite, rank, world, init_file, out = sys.argv[1:]
    rank, world, out = int(rank), int(world), Path(out)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        arrays, info = SUITES[suite](rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(out / f"rank{rank}.npz", **arrays)
    (out / f"rank{rank}.json").write_text(json.dumps(info))


if __name__ == "__main__":
    main()
