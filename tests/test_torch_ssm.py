"""The port's Mamba2 / SSD block (`repro_torch.models.ssm`) and the SSM
stacks against the JAX package, on the CPU.

The same inputs, made from numpy seeds, go through `repro.models.ssm` and
`repro_torch.models.ssm` (parameters: the reference's, at `reduced()`
sizes), fp32. Tolerance: rtol 1e-4 / atol 1e-4, the reference's own for its
chunked scan against its sequential one (the log-space decays and chunked
sums reorder fp32 rounding); 2e-3 for a block's prefill + decode against its
full-sequence run, as the reference's test allows.

  * `_ssd_chunked` against the reference's and against `ssd_naive` at
    (S, chunk) = (32, 8), (64, 16), (48, 16) and (17, 8) (the chunk halves
    until it divides S: 17 takes chunks of 1), and from a non-zero `h0`;
  * `_causal_conv`, `ssm_block` (output and its {h, conv} cache: the conv
    window keeps the pre-activation tail) and `ssm_decode_block`;
  * reduced mamba2-130m and zamba2-7b: forward, prefill and three decode
    steps (logits, hidden, every layer's SSM state and KV cache) against
    the reference; zamba2's shared attention is one parameter set, applied
    at each `shared_attn` position with a KV cache of its own; decode
    against the forward's last position.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from _torch_lm import (
    check_decode_matches_forward,
    check_forward,
    check_prefill_and_decode,
    close,
    configs,
    make_model,
)

torch.set_num_threads(1)

SSM = ("mamba2-130m", "zamba2-7b")
# two repeats of zamba2's unit: two `shared_attn` occurrences
DEPTH = {"zamba2-7b": {"n_layers": 12}}


def _scan_inputs(seed, b, s, nh, hd, st, h0=False):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    a = (1 / (1 + np.exp(-(rng.standard_normal((b, s, nh)) + 1.0)))).astype(np.float32)
    bb = rng.standard_normal((b, s, st)).astype(np.float32)
    cc = rng.standard_normal((b, s, st)).astype(np.float32)
    h = rng.standard_normal((b, nh, hd, st)) if h0 else np.zeros((b, nh, hd, st))
    return xh, a, bb, cc, h.astype(np.float32)


@pytest.mark.parametrize("s,chunk,h0", [(32, 8, False), (64, 16, False), (48, 16, False),
                                        (17, 8, False), (16, 8, True)])
def test_ssd_chunked_matches_the_reference_and_the_recurrence(s, chunk, h0):
    args = _scan_inputs(s + chunk, 2, s, 3, 4, 5, h0)
    y, h = S._ssd_chunked(*map(torch.from_numpy, args), chunk)
    jy, jh = JS._ssd_chunked(*map(jnp.asarray, args), chunk)
    close(y, jy)
    close(h, jh)
    ny, nh = S.ssd_naive(*map(torch.from_numpy, args))
    close(y, ny.numpy())
    close(h, nh.numpy())
    jny, jnh = JS.ssd_naive(*map(jnp.asarray, args))
    close(ny, jny)
    close(nh, jnh)


def _ssm_block(seed):
    cfg, jcfg = configs("mamba2-130m")
    jparams = JS.init_ssm_params(jax.random.PRNGKey(seed), jcfg)
    params = {name: torch.from_numpy(np.array(a)) for name, a in jparams.items()}
    return cfg, params, jcfg, jparams


def test_causal_conv_matches_the_reference():
    rng = np.random.default_rng(1)
    xbc, w, bias = (rng.standard_normal(sh).astype(np.float32) for sh in ((2, 9, 6), (4, 6), (6,)))
    close(S._causal_conv(*map(torch.from_numpy, (xbc, w, bias))),
          JS._causal_conv(*map(jnp.asarray, (xbc, w, bias))))


def test_ssm_block_and_decode_match_the_reference():
    cfg, params, jcfg, jparams = _ssm_block(2)
    x = 0.1 * np.random.default_rng(3).standard_normal((2, 17, cfg.d_model)).astype(np.float32)
    out, cache = S.ssm_block(params, cfg, torch.from_numpy(x[:, :-1]), return_cache=True)
    jout, jcache = JS.ssm_block(jparams, jcfg, jnp.asarray(x[:, :-1]), return_cache=True)
    close(out, jout)
    assert cache["h"].dtype == torch.float32
    assert cache["conv"].shape == (2, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
    close(cache["h"], jcache["h"])
    close(cache["conv"], jcache["conv"])
    last, cache = S.ssm_decode_block(params, cfg, torch.from_numpy(x[:, -1:]), cache)
    jlast, jcache = JS.ssm_decode_block(jparams, jcfg, jnp.asarray(x[:, -1:]), jcache)
    close(last, jlast)
    close(cache["h"], jcache["h"])
    close(cache["conv"], jcache["conv"])
    # prefill + decode against the full-sequence block
    full = S.ssm_block(params, cfg, torch.from_numpy(x))
    close(out, full[:, :-1].numpy(), 2e-3, 2e-3)
    close(last, full[:, -1:].numpy(), 2e-3, 2e-3)


@pytest.fixture(scope="module", params=SSM)
def model(request):
    return make_model(request.param, **DEPTH.get(request.param, {}))


def test_forward_matches_the_reference(model):
    check_forward(model)


def test_prefill_and_decode_match_the_reference(model):
    check_prefill_and_decode(model, 32)


def test_shared_attention_is_one_parameter_set():
    """zamba2's `shared_attn` positions hold no parameters of their own and
    all read `LMParams.shared_attn`; each keeps its own KV cache."""
    cfg, params, _, jparams, _ = make_model("zamba2-7b", **DEPTH["zamba2-7b"])
    kinds = cfg.layer_kinds()
    shared = [i for i, kind in enumerate(kinds) if kind == "shared_attn"]
    assert len(shared) == 2 and all(len(list(params.layers[i].parameters())) == 0 for i in shared)
    close(params.shared_attn["attn"]["wq"], jparams["shared_attn"]["attn"]["wq"])
    cache = T.make_cache(cfg, 2, 8, device="cpu")
    assert all(set(cache[i]) == {"k", "v"} for i in shared)
    assert all(set(cache[i]) == {"h", "conv"} for i, kind in enumerate(kinds) if kind == "ssm")
    held = sum(p.numel() for p in params.parameters())
    assert held == sum(a.size for a in jax.tree.leaves(jparams))


@pytest.mark.parametrize("name", SSM)
def test_decode_matches_the_forward_last_position(name):
    check_decode_matches_forward(name)
