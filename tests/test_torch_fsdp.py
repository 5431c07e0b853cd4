"""The port's FSDP per-layer gather (`repro_torch.models.transformer`
under `distributed.hints.use_hints(mesh, fsdp=True)`), on the CPU.

  * On gloo: 4 ranks of `_torch_comm_worker.py` (suite fsdp) run reduced
    gemma3-1b's loss, gradients and one AdamW step on a (2, 2) mesh, the
    parameters and moments placed by the FSDP specs; the loss within 1e-5
    and every gradient leaf within 1e-4 of its largest magnitude of the
    single-process step (the train tests' tolerances), which is itself held
    to `repro.train.train_step.loss_fn`'s loss; the stepped parameters and
    moments as the train tests hold a step. The same loss and gradients of
    a MoE config (the expert-parallel block on DTensors: gradients as
    partial sums over the data axis) and an SSM config (the SSD scan), and
    each rank's load-balance sum against the single-process one of its
    rows; one decode step on a cache whose batch and sequence are sharded
    (the scattered write into each rank's block), its logits and cache
    against the single-process step's.
  * On a fake group of 16 ranks (a 4 x 4 mesh), a traced FSDP train step
    gathers each layer's parameters as the layer starts, inside the remat:
    in the forward, and again in the backward's recomputation, never all
    layers' at once; the gradients are reduce-scattered back.
  * Without hints, or with plain parameters under them, `forward` is
    bitwise what it was.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline as PIPE
from repro_torch.distributed import hints as H
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as SPEC
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS
from _torch_gloo import (DECODE_POS, DECODE_SMAX, FSDP_ARCH, FSDP_BATCH, FSDP_CASES, FSDP_MESH,
                         FSDP_SEQ, STEP_OPT, fsdp_case_cfg, run_ranks, verdicts)

LOSS_TOL, GRAD_TOL, LB_TOL, OUT_TOL = 1e-5, 1e-4, 1e-6, 1e-5
WORLD = 4


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    return tmp_path_factory.mktemp("fsdp")


@pytest.fixture(scope="module")
def ranks(out):
    return run_ranks("fsdp", WORLD, out)


def _assert_leaf_close(got, want, tol, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + 1e-12, (what, err, scale)


@pytest.fixture(scope="module")
def single():
    """The single-process loss, gradients and step on the same parameters
    and batch."""
    cfg = reduced(get_arch(FSDP_ARCH))
    params = T.init_params(cfg, seed=0, device="cpu")
    batch = PIPE.batch_for_step(cfg, 0, FSDP_BATCH, FSDP_SEQ, device="cpu")
    loss, _, grads = TS.loss_and_grads(params, cfg, batch, act_dtype=torch.float32)
    named = dict(params.named_parameters())
    jloss, _ = JTS.loss_fn(convert.lm_params_to_jax({n: p.clone() for n, p in named.items()}, cfg),
                           jreduced(jget_arch(FSDP_ARCH)),
                           {"tokens": jnp.asarray(batch["tokens"].numpy())},
                           act_dtype=jnp.float32)
    step = TS.make_train_step(cfg, O.AdamWConfig(**STEP_OPT), act_dtype=torch.float32)
    state, metrics = step(TS.TrainState(params, O.init(named)), batch)
    return {"loss": float(loss), "jloss": float(jloss), "grads": grads,
            "step_loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": {n: p.numpy() for n, p in state.params.named_parameters()},
            "mu": {n: v.numpy() for n, v in state.opt.mu.items()},
            "nu": {n: v.numpy() for n, v in state.opt.nu.items()}}


def test_single_process_loss_matches_reference(single):
    assert abs(single["loss"] - single["jloss"]) <= LOSS_TOL


def test_fsdp_loss_and_gradients_match_single_process(ranks, single):
    for r, arrays in enumerate(ranks):
        assert abs(float(arrays["loss"]) - single["loss"]) <= LOSS_TOL, r
        for name, want in single["grads"].items():
            got = arrays[f"grad/{name}"]
            scale = float(want.abs().max())
            err = float(np.abs(got - want.numpy()).max())
            assert err <= GRAD_TOL * scale + 1e-12, (r, name, err, scale)


def test_fsdp_step(ranks, single):
    """The step's loss and gradient norm (over DTensor gradients brought to
    the moments' placements) are the single-process step's; the stepped
    parameters agree across ranks and are the single-process step's as the
    train tests hold a step: the first AdamW step moves an element by about
    lr * g / |g|, which rounding decides where g lies near the fp32 noise
    floor, so each leaf within 2 * lr and all but 1 in 1,000 elements within
    1e-6; the moments, linear in the gradients, within 1e-4 of each leaf's
    largest magnitude."""
    cfg = reduced(get_arch(FSDP_ARCH))
    sizes = {"data": 2, "model": 2}
    specs = SH.param_shardings(sizes, T.init_params(cfg, device="meta"), fsdp=True)
    lr = STEP_OPT["lr"]
    for r, arrays in enumerate(ranks):
        assert abs(float(arrays["step_loss"]) - single["step_loss"]) <= LOSS_TOL
        assert abs(float(arrays["grad_norm"]) - single["grad_norm"]) \
            <= LOSS_TOL * max(single["grad_norm"], 1.0)
        moved, n = 0, 0
        for name, want in single["params"].items():
            got = arrays[f"param/{name}"]
            np.testing.assert_array_equal(got, ranks[0][f"param/{name}"])
            err = np.abs(got - want)
            assert float(err.max()) <= 2 * lr, (r, name, float(err.max()))
            moved, n = moved + int((err > 1e-6).sum()), n + err.size
            for tree in ("mu", "nu"):
                _assert_leaf_close(arrays[f"{tree}/{name}"], single[tree][name], GRAD_TOL,
                                   (r, tree, name))
        assert moved <= 1e-3 * n, (r, moved, n)
    assert any(any(isinstance(e, tuple) for e in s) for s in specs.values())  # data-sharded leaves


# ---------------------------------------------------------------------------
# the MoE and SSM paths, and a decode step, on DTensors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(FSDP_CASES))
def test_fsdp_case_matches_single_process(ranks, case):
    """The loss and each gradient leaf (no load-balance term) are the
    single-process ones; each rank's load-balance sum is the
    single-process one of the rows its data coordinate holds (the
    expert-parallel block returns each rank's own, as the reference's
    `shard_map` does)."""
    cfg = fsdp_case_cfg(case)
    params = T.init_params(cfg, seed=0, device="cpu")
    batch = PIPE.batch_for_step(cfg, 0, FSDP_BATCH, FSDP_SEQ, device="cpu")
    loss, _, grads = TS.loss_and_grads(params, cfg, batch, act_dtype=torch.float32, aux_weight=0.0)
    rows = FSDP_BATCH // FSDP_MESH[0]
    lbs = []
    with torch.no_grad():
        for d in range(FSDP_MESH[0]):
            part = {k: v[d * rows : (d + 1) * rows] for k, v in batch.items()}
            lbs.append(float(T.forward(params, cfg, part, act_dtype=torch.float32)[1]))
    assert (lbs[0] > 0) == bool(cfg.n_experts)
    for r, arrays in enumerate(ranks):
        assert abs(float(arrays[f"{case}/loss"]) - float(loss)) <= LOSS_TOL, r
        d = int(arrays["coord"][0])
        assert abs(float(arrays[f"{case}/moe_aux"]) - lbs[d]) <= LB_TOL, (r, lbs)
        for name, want in grads.items():
            _assert_leaf_close(arrays[f"{case}/grad/{name}"], want.numpy(), GRAD_TOL,
                               (r, case, name))


def test_decode_on_sharded_cache_matches_single_process(ranks, out):
    """One decode step, each row at its own position in either sequence
    block of the sharded cache: the logits, and every layer's cache (the
    written slots and the untouched ones), are the single-process step's."""
    cfg = reduced(get_arch(FSDP_ARCH))
    params = T.init_params(cfg, seed=0, device="cpu")
    prompt = PIPE.batch_for_step(cfg, 0, FSDP_BATCH, FSDP_SEQ, device="cpu")
    with torch.no_grad():
        _, caches, _ = T.prefill(params, cfg, prompt, s_max=DECODE_SMAX, act_dtype=torch.float32)
        logits, caches = T.decode_step(params, cfg, caches, prompt["tokens"][:, -1].contiguous(),
                                       torch.tensor(DECODE_POS, dtype=torch.int32),
                                       act_dtype=torch.float32)
    info = verdicts(out, WORLD)
    assert info[0]["decode/cache0"]["k"] == [0, 1]  # batch over data, sequence over model
    for r, arrays in enumerate(ranks):
        _assert_leaf_close(arrays["decode/logits"], logits.numpy(), OUT_TOL, (r, "logits"))
        for i, cache in enumerate(caches):
            for k, v in cache.items():
                _assert_leaf_close(arrays[f"decode/cache{i}/{k}"], v.numpy(), OUT_TOL,
                                   (r, i, k))


# ---------------------------------------------------------------------------
# the gather's schedule, traced over a fake group
# ---------------------------------------------------------------------------


def test_gather_is_per_layer_inside_the_remat(monkeypatch):
    """Events of one traced FSDP train step: `G k` where a layer's gather
    issued k all-gathers, `A` where a layer's computation ended. The
    forward runs G A per layer, the backward's recomputation gathers each
    layer again, last layer first; every gather issues one all-gather per
    data-sharded parameter of its layer."""
    monkeypatch.setenv("REPRO_TORCH_MESH_OVERRIDE", "4,4")
    monkeypatch.setattr(SPEC, "parallelism_policy", lambda *a: "fsdp")
    cfg = reduced(get_arch(FSDP_ARCH))
    events, counter = [], DR.RankCounter()
    gather, apply_layer = T._fsdp_gather, T._apply_layer

    def logged_gather(lp):
        before = counter.n_collectives["all-gather"]
        out = gather(lp)
        events.append(("G", counter.n_collectives["all-gather"] - before))
        return out

    def logged_apply(*args):
        out = apply_layer(*args)
        events.append(("A", 0))
        return out

    monkeypatch.setattr(T, "_fsdp_gather", logged_gather)
    monkeypatch.setattr(T, "_apply_layer", logged_apply)
    with DR.fake_group(16):
        mesh = make_production_mesh(device="cpu")
        fn, args = SPEC.make_cell(FSDP_ARCH, ShapeConfig("t", 64, 16, "train"), mesh,
                                  cfg_override=cfg)
        with counter:
            fn(*args)
        sizes = SH.axis_sizes(mesh)
        specs = SH.param_shardings(sizes, args[0].params, fsdp=True)
    per_layer = [sum(1 for name, s in specs.items() if name.startswith(f"layers.{i}.")
                     and any(isinstance(e, tuple) for e in s)) for i in range(cfg.n_layers)]
    n = cfg.n_layers
    forward, backward = events[: 2 * n], events[2 * n :]
    assert [tag for tag, _ in forward] == ["G", "A"] * n
    assert [k for tag, k in forward if tag == "G"] == per_layer
    # the recomputation may stop once the layer's saved tensors are back
    # (so an "A" may be missing there), but each layer gathers first
    assert [k for tag, k in backward if tag == "G"] == per_layer[::-1], backward
    assert backward[0][0] == "G"
    assert all(k > 0 for k in per_layer)
    assert counter.n_collectives["reduce-scatter"] >= sum(per_layer)


# ---------------------------------------------------------------------------
# the plain path is as it was
# ---------------------------------------------------------------------------


def _layer_by_layer(params, cfg, batch):
    """The forward composed by hand from its pieces, as before the gather."""
    x, positions = T.embed_inputs(params, cfg, batch, torch.float32)
    bpos = positions[None, :].expand(x.shape[0], -1)
    for lp, (kind, mlp_kind) in zip(params.layers, T.layer_descs(cfg)):
        x, _, _ = T._apply_layer(lp, params.shared_attn, cfg, kind, mlp_kind, x, bpos)
    return T.lm_logits(params, cfg, L.rms_norm(x, params.final_norm, cfg.norm_eps))


def test_forward_without_hints_is_bitwise_unchanged():
    cfg = reduced(get_arch(FSDP_ARCH))
    params = T.init_params(cfg, seed=1, device="cpu")
    batch = PIPE.batch_for_step(cfg, 3, 2, FSDP_SEQ, device="cpu")
    want = _layer_by_layer(params, cfg, batch)
    with torch.no_grad():
        plain, _ = T.forward(params, cfg, batch, act_dtype=torch.float32, remat=False)
    rematted, _ = T.forward(params, cfg, batch, act_dtype=torch.float32, remat=True)
    assert torch.equal(plain, want) and torch.equal(rematted.detach(), want)
    with DR.fake_group(1):
        mesh = make_debug_mesh((1, 1), device="cpu")
        with H.use_hints(mesh, fsdp=True):
            hinted, _ = T.forward(params, cfg, batch, act_dtype=torch.float32, remat=True)
    assert torch.equal(hinted.detach(), want)
