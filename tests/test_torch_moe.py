"""The port's MoE block (`repro_torch.models.moe`) against the JAX package,
on the CPU.

The same inputs, made from numpy seeds, go through `repro.models.moe` and
`repro_torch.models.moe` with the reference's parameters at `reduced()`
sizes, fp32 activations. Tolerance: rtol 1e-4 / atol 1e-4 on outputs and the
load-balance loss (the same arithmetic; XLA and PyTorch sum matmuls in other
orders); the routed expert ids, the kept set of a capacity-capped dispatch
and `moe_drop_frac` exactly.

  * `moe_block` with no drops (capacity 8), against the reference and
    against a per-token loop over the experts;
  * at capacity 0.1: the kept assignments equal a numpy stable sort's by
    the reference's definition, `moe_drop_frac` equal to the reference's
    bit for bit, the output within tolerance;
  * shared experts (they change the output), `moe_lb_loss`;
  * top-k expert ids exactly the reference's: a flip is allowed only at a
    near-tie of the router's probabilities (within 1e-6), and the flips are
    counted in the assertion message, not seeded away;
  * reduced deepseek-moe-16b and qwen3-moe-235b-a22b: forward (with its
    aux), prefill and three decode steps against the reference, and decode
    against the forward's last position.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch.models import moe as M
from _torch_lm import (
    check_decode_matches_forward,
    check_forward,
    check_prefill_and_decode,
    close,
    configs,
    make_model,
)

torch.set_num_threads(1)

MOE = ("deepseek-moe-16b", "qwen3-moe-235b-a22b")
TIE = 1e-6  # router probabilities this close may rank either way


def _tree(p):
    if isinstance(p, dict):
        return {name: _tree(v) for name, v in p.items()}
    return torch.from_numpy(np.array(p))


def _block(seed: int, b: int, s: int, **overrides):
    """(cfg, params, jcfg, jparams, x) of one MoE block of reduced deepseek."""
    cfg, jcfg = configs("deepseek-moe-16b", **overrides)
    jparams = JM.init_moe_params(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return cfg, _tree(jparams), jcfg, jparams, x


def _run(block):
    cfg, params, jcfg, jparams, x = block
    got, aux = M.moe_block(params, cfg, torch.from_numpy(x))
    want, jaux = jax.jit(lambda p, xx: JM.moe_block(p, jcfg, xx))(jparams, jnp.asarray(x))
    return got, aux, want, jaux


def test_moe_block_without_drops_matches_the_reference_and_a_token_loop():
    block = _block(1, 2, 16, moe_capacity_factor=8.0, n_shared_experts=0)
    cfg, params, _, _, x = block
    got, aux, want, jaux = _run(block)
    assert float(aux["moe_drop_frac"]) == float(jaux["moe_drop_frac"]) == 0.0
    close(got, want)
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, w, idx = M.route(params, cfg, xt)
    loop = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(cfg.top_k):
            e = int(idx[t, j])
            g = torch.nn.functional.silu(xt[t] @ params["wi_gate"][e])
            loop[t] += w[t, j] * ((g * (xt[t] @ params["wi_up"][e])) @ params["wo"][e])
    close(got.reshape(-1, cfg.d_model), loop)


def test_top_k_ids_equal_the_reference_but_at_near_ties():
    cfg, params, jcfg, jparams, x = _block(2, 8, 32)
    xt = x.reshape(-1, cfg.d_model)
    probs, _, idx = M.route(params, cfg, torch.from_numpy(xt))
    jprobs = jax.nn.softmax(jnp.asarray(xt) @ jparams["router"], axis=-1)
    _, jidx = jax.lax.top_k(jprobs, cfg.top_k)
    close(probs, jprobs, 1e-5, 1e-6)
    flipped = (idx.numpy() != np.asarray(jidx)).any(1)
    # a row may differ only where two of its top-(k+1) probabilities tie
    top = np.sort(np.asarray(jprobs), axis=1)[:, ::-1][:, : cfg.top_k + 1]
    tied = (np.diff(top, axis=1) > -TIE).any(1)
    assert not (flipped & ~tied).any(), f"{int(flipped.sum())} rows flipped, not at near-ties"
    assert int(flipped.sum()) <= int(tied.sum()), f"{int(flipped.sum())} near-tie flips"


def test_capacity_drops_equal_the_reference():
    block = _block(3, 4, 32, moe_capacity_factor=0.1)
    cfg, params, _, _, x = block
    got, aux, want, jaux = _run(block)
    t, k, e = 4 * 32, cfg.top_k, cfg.n_experts
    _, _, idx = M.route(params, cfg, torch.from_numpy(x).reshape(t, -1))
    # the reference's kept set: a stable sort by expert, the first C of each
    flat = idx.reshape(-1).numpy()
    order = np.argsort(flat, kind="stable")
    rank = np.empty(t * k, np.int64)
    for ex in range(e):
        seg = order[flat[order] == ex]
        rank[seg] = np.arange(seg.size)
    kept = rank < M._capacity(cfg, t)
    assert 0 < kept.sum() < t * k
    assert float(aux["moe_drop_frac"]) == float(jaux["moe_drop_frac"]) == 1.0 - kept.mean(
        dtype=np.float32)
    close(got, want)
    # the kept set decides the output: the same block with the kept
    # assignments' experts recomputed by a token loop
    xt = torch.from_numpy(x).reshape(t, -1)
    _, w, _ = M.route(params, cfg, xt)
    loop = torch.zeros_like(xt)
    for a in np.nonzero(kept)[0]:
        tt, j = divmod(int(a), k)
        ex = int(idx[tt, j])
        g = torch.nn.functional.silu(xt[tt] @ params["wi_gate"][ex])
        loop[tt] += w[tt, j] * ((g * (xt[tt] @ params["wi_up"][ex])) @ params["wo"][ex])
    sp = params["shared"]
    loop += (torch.nn.functional.silu(xt @ sp["wi_gate"]) * (xt @ sp["wi_up"])) @ sp["wo"]
    close(got.reshape(t, -1), loop)


def test_shared_experts_and_load_balance_loss():
    block = _block(4, 2, 16, n_shared_experts=1)
    cfg, params, _, _, x = block
    got, aux, want, jaux = _run(block)
    close(got, want)
    close(aux["moe_lb_loss"], jaux["moe_lb_loss"])
    assert float(aux["moe_lb_loss"]) > 0.0
    zeroed = dict(params, shared={n: torch.zeros_like(v) for n, v in params["shared"].items()})
    without, _ = M.moe_block(zeroed, cfg, torch.from_numpy(x))
    assert float((got - without).abs().max()) > 1e-4


def test_moe_block_repeats_bitwise():
    cfg, params, _, _, x = _block(5, 4, 32, moe_capacity_factor=0.5)
    first, _ = M.moe_block(params, cfg, torch.from_numpy(x))
    again, _ = M.moe_block(params, cfg, torch.from_numpy(x))
    assert torch.equal(first, again)


@pytest.fixture(scope="module", params=MOE)
def model(request):
    return make_model(request.param)


def test_forward_matches_the_reference(model):
    check_forward(model)


def test_prefill_and_decode_match_the_reference(model):
    check_prefill_and_decode(model, 32)


@pytest.mark.parametrize("name", MOE)
def test_decode_matches_the_forward_last_position(name):
    check_decode_matches_forward(name)
