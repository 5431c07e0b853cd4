"""The port's expert-parallel MoE (`repro_torch.models.moe._moe_block_ep`,
`moe_block` under `distributed.hints.use_hints`) on gloo, on the CPU.

The ranks of `_torch_comm_worker.py` (a module fixture starts 2 ranks, then
4) run `moe_block` on (data, model) meshes (1, 2), (2, 2) and (1, 4), each
rank holding its data shard's rows and its E / n_ep experts, for the
reference test's three variants (`tests/test_moe_ep.py`: plain (8, 2, 0),
shared (8, 2, 1), finegrained (16, 4, 2) as (experts, top-k, shared)) at
capacity factor 16, fp32:

  * each rank's output rows within 1e-5 x max(|y|, 1) of the port's dense
    `moe_block` on the same rows, its load-balance loss within 1e-6 of the
    dense block's on those rows;
  * the gradients of sum(y^2), gathered (the router's and the shared
    experts' summed over the data ranks, the experts' summed over the data
    ranks and concatenated over the model ranks, the input's rows
    concatenated), within 1e-3 of the dense block's on the whole batch
    (the reference test's tolerances); the replicated gradients equal
    across a model group;
  * no drops on either path;
  * `_permute_ffn` with each rank's `e_local` / `e_offset` against the
    reference's `_permute_ffn` on the same inputs, at capacity 16 and at
    0.5 (where it drops): outputs within 1e-5 of the largest magnitude, the
    drop fraction (the kept count over the in-range count) exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.models import moe as JM
from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe as M
from _torch_gloo import (MOE_CAPACITY, MOE_MESHES, MOE_VARIANTS, PERMUTE_CAPACITY, mesh_name,
                         moe_cfg_kwargs, moe_x, run_ranks)

OUT_TOL, LB_TOL, GRAD_TOL, PERMUTE_TOL = 1e-5, 1e-6, 1e-3, 1e-5
CASES = [(w, shape) for w, shapes in MOE_MESHES.items() for shape in shapes]
CASE_IDS = [mesh_name(shape) for _, shape in CASES]
EXPERT_LEAVES = ("wi_gate", "wi_up", "wo")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: every rank's arrays} of the moe suite."""
    return {w: run_ranks("moe", w, tmp_path_factory.mktemp(f"moe{w}")) for w in MOE_MESHES}


def _model(variant: str, capacity: float = MOE_CAPACITY):
    cfg = ArchConfig(**moe_cfg_kwargs(variant, capacity))
    return cfg, M.init_moe_params(torch.Generator().manual_seed(0), cfg)


def _rows(arrays, key, n_data):
    """This rank's (data rank, model rank) and its rows of the batch."""
    d, m = (int(v) for v in arrays[f"{key}/coord"])
    xg = moe_x()
    rows = xg.shape[0] // n_data
    return d, m, xg[d * rows : (d + 1) * rows]


@pytest.mark.parametrize("variant", list(MOE_VARIANTS))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_ep_output_matches_dense(runs, case, variant):
    world, shape = case
    cfg, params = _model(variant)
    key = mesh_name(shape)
    for arrays in runs[world]:
        _, _, rows = _rows(arrays, key, shape[0])
        with torch.no_grad():
            want, aux = M.moe_block(params, cfg, torch.from_numpy(rows))
        got = arrays[f"{key}/{variant}/y"]
        scale = float(want.abs().max())
        assert float(np.abs(got - want.numpy()).max()) < OUT_TOL * max(scale, 1.0)
        assert abs(float(arrays[f"{key}/{variant}/lb"]) - float(aux["moe_lb_loss"])) <= LB_TOL


@pytest.mark.parametrize("variant", list(MOE_VARIANTS))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_ep_gradients_match_dense(runs, case, variant):
    world, (n_data, n_ep) = case
    cfg, full = _model(variant)
    key = mesh_name((n_data, n_ep))
    params = {k: ({kk: t.clone().requires_grad_(True) for kk, t in v.items()}
                  if isinstance(v, dict) else v.clone().requires_grad_(True))
              for k, v in full.items()}
    x = torch.from_numpy(moe_x()).requires_grad_(True)
    y, _ = M.moe_block(params, cfg, x)
    (y**2).sum().backward()
    want = {"x": x.grad.numpy()}
    for name, v in params.items():
        for sub, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            want[name if sub is None else f"{name}.{sub}"] = t.grad.numpy()

    by_coord = {}
    for arrays in runs[world]:
        d, m, _ = _rows(arrays, key, n_data)
        by_coord[d, m] = {k.split("/grad/")[1]: v for k, v in arrays.items()
                          if k.startswith(f"{key}/{variant}/grad/")}
    got = {}
    for leaf in want:
        if leaf == "x":
            got[leaf] = np.concatenate([by_coord[d, 0][leaf] for d in range(n_data)])
        elif leaf in EXPERT_LEAVES:
            got[leaf] = np.concatenate([sum(by_coord[d, m][leaf] for d in range(n_data))
                                        for m in range(n_ep)])
        else:  # replicated: the same on every rank of a model group
            for d in range(n_data):
                for m in range(1, n_ep):
                    np.testing.assert_array_equal(by_coord[d, m][leaf], by_coord[d, 0][leaf])
            got[leaf] = sum(by_coord[d, 0][leaf] for d in range(n_data))
    assert set(got) == set(want)
    for leaf, w in want.items():
        assert got[leaf].shape == w.shape, leaf
        assert float(np.abs(got[leaf] - w).max()) < GRAD_TOL, (leaf, float(np.abs(w).max()))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_no_drops_at_high_capacity(runs, case):
    world, shape = case
    for variant in MOE_VARIANTS:
        cfg, params = _model(variant)
        with torch.no_grad():
            _, aux = M.moe_block(params, cfg, torch.from_numpy(moe_x()))
        assert float(aux["moe_drop_frac"]) == 0.0
        for arrays in runs[world]:
            assert float(arrays[f"{mesh_name(shape)}/{variant}/drop"]) == 0.0


@pytest.mark.parametrize("capacity", [MOE_CAPACITY, PERMUTE_CAPACITY], ids=["cap16", "cap0.5"])
@pytest.mark.parametrize("variant", list(MOE_VARIANTS))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_permute_ffn_matches_reference(runs, case, variant, capacity):
    world, (n_data, n_ep) = case
    cfg, full = _model(variant, capacity)
    jcfg = JArchConfig(**moe_cfg_kwargs(variant, capacity))
    key = mesh_name((n_data, n_ep))
    e_loc = cfg.n_experts // n_ep
    drops = []
    for arrays in runs[world]:
        _, m, rows = _rows(arrays, key, n_data)
        pre = f"{key}/{variant}"
        experts = {k: jnp.asarray(full[k][m * e_loc : (m + 1) * e_loc].numpy())
                   for k in EXPERT_LEAVES}
        want, jdrop = JM._permute_ffn(
            None, jcfg, jnp.asarray(rows.reshape(-1, cfg.d_model)), None,
            jnp.asarray(arrays[f"{pre}/w"]), jnp.asarray(arrays[f"{pre}/idx"]),
            e_local=e_loc, e_offset=m * e_loc, **experts)
        want = np.asarray(want)
        got = arrays[f"{pre}/permute{capacity}/y"]
        assert float(np.abs(got - want).max()) <= PERMUTE_TOL * float(np.abs(want).max()) + 1e-12
        got_drop = arrays[f"{pre}/permute{capacity}/drop"]
        assert got_drop == np.asarray(jdrop), (got_drop, jdrop)
        drops.append(float(got_drop))
    if capacity == PERMUTE_CAPACITY:
        assert max(drops) > 0  # the kept sets were compared where they differ from the in-range ones
    else:
        assert max(drops) == 0
