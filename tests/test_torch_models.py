"""The port's LM stack against the JAX package, on the CPU: the dense text
families and the audio and vision frontends (the MoE and SSM families are
in `test_torch_moe.py` and `test_torch_ssm.py`).

The same inputs, made from numpy seeds, go through `repro.models` and
`repro_torch.models` at `reduced()` sizes; parameters are the reference's
`init_params`, carried across with `convert.lm_params_from_jax`. Activations
are fp32 on both sides. Tolerance: rtol 1e-4 / atol 1e-4 (the same
arithmetic, op for op; XLA and PyTorch sum matmuls in other orders).

  * the primitives: `rms_norm`, `rope_freqs` + `apply_rope`, `softcap`,
    `gated_mlp`;
  * attention: full (causal, windowed, soft-capped, GQA), blockwise with
    several q- and kv-chunks (global and windowed), single-token decode,
    and the block's switch to blockwise past a threshold;
  * `forward` (logits and hidden), `prefill` and three `decode_step`s
    (logits, hidden, every layer's KV cache) for the four dense text
    architectures; a decode at pos >= s_max clamps its cache write to the
    last slot as the reference's `dynamic_update_slice` does;
  * musicgen-large (summed codebook embeddings, one head a codebook,
    (B, ncb) decode tokens) and internvl2-2b (patch embeddings projected
    through the tanh GELU before the text; text-only decode): embed,
    logits, forward, prefill and three decode steps against the reference,
    and decode against the forward's last position (rtol / atol 5e-3, the
    reference's own);
  * `ServeEngine.generate` for audio and vision, greedy: tokens and
    `final_pos` equal the reference engine's (audio ignores `eos_id`);
  * `param_count` / `active_param_count` of all ten configs equal the
    reference's, and for each of the ten an initialised port model holds as
    many parameters as the reference's tree, and the converted tree every
    leaf of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import list_archs as jlist_archs
from repro.configs import reduced as jreduced
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_arch, list_archs, reduced
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import ServeEngine
from _torch_lm import (
    batch_for,
    check_decode_matches_forward,
    check_forward,
    check_prefill_and_decode,
    jbatch,
    make_model,
    tbatch,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-4
DENSE = ("gemma2-2b", "h2o-danube-1.8b", "gemma3-27b", "gemma3-1b")
FRONTENDS = ("musicgen-large", "internvl2-2b")
B, S, S_MAX = 2, 24, 32


def close(got, want):
    np.testing.assert_allclose(
        torch.as_tensor(got).numpy(), np.asarray(want), rtol=RTOL, atol=ATOL
    )


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- primitives -------------------------------------------------------------


def test_rms_norm_softcap_and_gated_mlp():
    rng = np.random.default_rng(0)
    x, scale = rand(rng, 3, 5, 64), rand(rng, 64) * 0.1
    close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
          JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    close(L.softcap(torch.from_numpy(x * 40), 30.0), JL.softcap(jnp.asarray(x * 40), 30.0))
    assert torch.equal(L.softcap(torch.from_numpy(x), 0.0), torch.from_numpy(x))
    wg, wu, wo = rand(rng, 64, 96) * 0.1, rand(rng, 64, 96) * 0.1, rand(rng, 96, 64) * 0.1
    close(L.gated_mlp(*map(torch.from_numpy, (x, wg, wu, wo))),
          JL.gated_mlp(*map(jnp.asarray, (x, wg, wu, wo))))


def test_rope_is_the_half_split_rotation():
    rng = np.random.default_rng(1)
    x = rand(rng, 2, 7, 3, 16)
    pos = np.broadcast_to(np.arange(7) * 97, (2, 7)).astype(np.int32)
    sin, cos = L.rope_freqs(torch.from_numpy(pos), 16, 1_000_000.0)
    jsin, jcos = JL.rope_freqs(jnp.asarray(pos), 16, 1_000_000.0)
    close(sin, jsin)
    close(cos, jcos)
    close(L.apply_rope(torch.from_numpy(x), sin, cos),
          JL.apply_rope(jnp.asarray(x), jsin, jcos))


# -- attention --------------------------------------------------------------


def _attn_inputs(seed, h=4, kv=2, dh=16, s=64):
    rng = np.random.default_rng(seed)
    return rand(rng, 2, s, h, dh), rand(rng, 2, s, kv, dh), rand(rng, 2, s, kv, dh)


@pytest.mark.parametrize("window", [0, 12])
def test_full_and_blockwise_attention_match_the_reference(window):
    cfg = reduced(get_arch("gemma2-2b"))  # soft-capped scores, GQA 4:2
    jcfg = jreduced(jget_arch("gemma2-2b"))
    q, k, v = _attn_inputs(2)
    pos = np.arange(q.shape[1])
    t = [torch.from_numpy(a) for a in (q, k, v)]
    j = [jnp.asarray(a) for a in (q, k, v)]
    full = A.full_attention(*t, cfg, torch.from_numpy(pos), torch.from_numpy(pos), window=window)
    close(full, JA.full_attention(*j, jcfg, jnp.asarray(pos), jnp.asarray(pos), window=window))
    # several q-chunks, and several kv-chunks on the global path
    blk = A.blockwise_attention(*t, cfg, window=window, q_chunk=16, kv_chunk=8)
    close(blk, JA.blockwise_attention(*j, jcfg, window=window, q_chunk=16, kv_chunk=8))
    close(blk, full)


def test_attention_block_switches_to_blockwise_past_the_threshold():
    cfg = reduced(get_arch("gemma3-1b"))
    jcfg = jreduced(jget_arch("gemma3-1b"))
    jp = JA.init_attn_params(jax.random.PRNGKey(3), jcfg)
    p = {name: torch.tensor(np.asarray(a)) for name, a in jp.items()}
    x = rand(np.random.default_rng(4), 2, 80, cfg.d_model)  # 80 > 2 * window (32)
    pos = np.broadcast_to(np.arange(80), (2, 80)).copy()
    for kind, thr in (("local", 8192), ("global", 16)):
        got, (k, v) = A.attention_block(p, cfg, torch.from_numpy(x), torch.from_numpy(pos),
                                        kind=kind, blockwise_threshold=thr)
        want, (jk, jv) = JA.attention_block(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), kind=kind,
                                            blockwise_threshold=thr)
        close(got, want)
        close(k, jk)
        close(v, jv)


@pytest.mark.parametrize("window", [0, 12])
def test_decode_attention_matches_the_reference(window):
    cfg = reduced(get_arch("gemma2-2b"))
    jcfg = jreduced(jget_arch("gemma2-2b"))
    q, k, v = _attn_inputs(5, s=40)
    q1 = q[:, :1]
    pos = np.array([17, 39], np.int32)
    got = A.decode_attention(torch.from_numpy(q1), torch.from_numpy(k), torch.from_numpy(v), cfg,
                             torch.from_numpy(pos), window=window)
    want = JA.decode_attention(jnp.asarray(q1), jnp.asarray(k), jnp.asarray(v), jcfg,
                               jnp.asarray(pos), window=window)
    close(got, want)


# -- the four dense text architectures ---------------------------------------


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    name = request.param
    jcfg, cfg = jreduced(jget_arch(name)), reduced(get_arch(name))
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return cfg, params, jcfg, jparams, tokens


def _jit(fn, *static):
    return jax.jit(fn, static_argnames=static)


def test_forward_logits_and_hidden_match_the_reference(model):
    cfg, params, jcfg, jparams, tokens = model
    jfwd = _jit(lambda p, t, h: JT.forward(p, jcfg, {"tokens": t}, act_dtype=jnp.float32,
                                           remat=False, return_hidden=h)[0], "h")
    for hidden in (False, True):
        got, aux = T.forward(params, cfg, {"tokens": torch.from_numpy(tokens)},
                             act_dtype=torch.float32, return_hidden=hidden)
        assert got.shape == (B, S, cfg.d_model if hidden else cfg.vocab)
        assert float(aux) == 0.0
        close(got, jfwd(jparams, jnp.asarray(tokens), hidden))


def _layer_caches(jcaches, cfg):
    """The reference's [segment][pos]{k, v}[rep] caches, one a layer."""
    out = [None] * cfg.n_layers
    for seg, seg_map in zip(jcaches, T.segment_layers(cfg)):
        for entry, layers in zip(seg, seg_map):
            for rep, layer in enumerate(layers):
                out[layer] = {name: np.asarray(a[rep]) for name, a in entry.items()}
    return out


def _decode_three(model, s_max: int, steps: int = 3):
    """Prefill, then `steps` greedy decode steps on both sides; yields the
    per-step (port, reference) outputs and caches."""
    cfg, params, jcfg, jparams, tokens = model
    jpre = _jit(lambda p, t: JT.prefill(p, jcfg, {"tokens": t}, s_max=s_max,
                                        act_dtype=jnp.float32, return_hidden=True))
    jdec = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jcfg, c, t, pos, act_dtype=jnp.float32,
                                                       return_hidden=True))
    jl, jc, jlen, jh = jpre(jparams, jnp.asarray(tokens))
    tl, tc, tlen, th = T.prefill(params, cfg, {"tokens": torch.from_numpy(tokens)}, s_max=s_max,
                                 act_dtype=torch.float32, return_hidden=True)
    assert tlen == int(jlen) == S
    yield (tl, th, tc), (jl, jh, jc)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = np.full((B,), S, np.int32)
    for _ in range(steps):
        jl, jc, jh = jdec(jparams, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc, th = T.decode_step(params, cfg, tc, torch.from_numpy(tok), torch.from_numpy(pos),
                                   act_dtype=torch.float32, return_hidden=True)
        yield (tl, th, tc), (jl, jh, jc)
        tok, pos = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), pos + 1


def test_prefill_and_decode_match_the_reference(model):
    cfg = model[0]
    for (tl, th, tc), (jl, jh, jc) in _decode_three(model, S_MAX):
        assert tl.shape == (B, cfg.vocab) and th.shape == (B, cfg.d_model)
        close(tl, jl)
        close(th, jh)
        for got, want in zip(tc, _layer_caches(jc, cfg)):
            assert got["k"].shape == (B, S_MAX, cfg.n_kv_heads, cfg.head_dim)
            close(got["k"], want["k"])
            close(got["v"], want["v"])


def test_decode_past_s_max_clamps_to_the_last_slot(model):
    """With s_max = the prompt length, every decode step writes at
    pos >= s_max: the reference's `dynamic_update_slice` clamps the start,
    so the last slot is overwritten and the cache keeps its size."""
    cfg = model[0]
    for step, ((tl, _, tc), (jl, _, jc)) in enumerate(_decode_three(model, S)):
        close(tl, jl)
        for got, want in zip(tc, _layer_caches(jc, cfg)):
            assert got["k"].shape[1] == S
            close(got["k"], want["k"])
            close(got["v"], want["v"])
        if step == 1:
            # the first decode step overwrote slot S - 1, the prompt's last
            first = _layer_caches(jc, cfg)[0]["k"][:, -1]
            close(tc[0]["k"][:, -1], first)


# -- configs ----------------------------------------------------------------


def test_param_counts_equal_the_reference_for_all_ten_configs():
    assert list_archs() == jlist_archs() and len(list_archs()) == 10
    for name in list_archs():
        cfg, jcfg = get_arch(name), jget_arch(name)
        assert cfg.param_count() == jcfg.param_count(), name
        assert cfg.active_param_count() == jcfg.active_param_count(), name
        assert reduced(cfg).param_count() == jreduced(jcfg).param_count(), name
    assert get_arch("gemma3-1b").param_count() == 999_811_584


@pytest.mark.parametrize("name", list_archs())
def test_an_initialised_model_holds_the_reference_parameters(name):
    """As many parameters as the reference's tree (`param_count()` leaves
    out the norm scales), and the converted tree every leaf of it."""
    cfg = reduced(get_arch(name))
    params = T.init_params(cfg, device="cpu")
    jcfg = jreduced(jget_arch(name))
    shapes = jax.eval_shape(lambda k: JT.init_params(k, jcfg), jax.random.PRNGKey(0))
    held = sum(p.numel() for p in params.parameters())
    assert held == sum(a.size for a in jax.tree.leaves(shapes))
    assert not any(p.requires_grad for p in params.parameters())
    assert len(params.layers) == cfg.n_layers
    # a tree of the reference's shapes, each leaf a distinct value
    leaves, treedef = jax.tree.flatten(shapes)
    tree = jax.tree.unflatten(treedef, [np.full(a.shape, i, np.float32) for i, a in enumerate(leaves)])
    carried = convert.lm_params_from_jax(tree, cfg, device="cpu")
    assert sorted(p.shape for p in carried.parameters()) == sorted(
        p.shape for p in params.parameters())
    assert sum(float(p.double().sum()) for p in carried.parameters()) == sum(
        i * a.size for i, a in enumerate(leaves))


# -- the audio and vision frontends --------------------------------------------


@pytest.fixture(scope="module", params=FRONTENDS)
def frontend(request):
    return make_model(request.param)


def test_frontend_embed_and_logits_match_the_reference(frontend):
    cfg, params, jcfg, jparams, batch = frontend
    x, pos = T.embed_inputs(params, cfg, tbatch(batch), act_dtype=torch.float32)
    jx, jpos = JT.embed_inputs(jparams, jcfg, jbatch(batch), act_dtype=jnp.float32)
    assert x.shape == (B, S, cfg.d_model) and torch.equal(pos, torch.arange(S))
    close(x, jx)
    logits = T.lm_logits(params, cfg, x)
    close(logits, JT.lm_logits(jparams, jcfg, jnp.asarray(x.numpy())))
    if cfg.modality == "audio_tokens":
        assert logits.shape == (B, S, cfg.n_codebooks, cfg.vocab)


def test_frontend_forward_matches_the_reference(frontend):
    check_forward(frontend)


def test_frontend_prefill_and_decode_match_the_reference(frontend):
    check_prefill_and_decode(frontend, S_MAX)


@pytest.mark.parametrize("name", FRONTENDS)
def test_frontend_decode_matches_the_forward_last_position(name):
    check_decode_matches_forward(name)


@pytest.mark.parametrize("name", FRONTENDS)
def test_generate_for_audio_and_vision_matches_the_reference_engine(name):
    cfg, params, jcfg, jparams, _ = make_model(name)
    batch = batch_for(cfg, 3, B, 16)
    want = JServeEngine(jcfg, jparams, s_max=S_MAX, act_dtype=jnp.float32).generate(
        jbatch(batch), max_new_tokens=5, eos_id=1)
    got = ServeEngine(cfg, params, s_max=S_MAX, act_dtype=torch.float32, device="cpu").generate(
        batch, max_new_tokens=5, eos_id=1)
    shape = (B, 5, cfg.n_codebooks) if cfg.modality == "audio_tokens" else (B, 5)
    assert got["tokens"].shape == shape and got["tokens"].dtype == torch.int32
    assert np.array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    assert np.array_equal(got["final_pos"].numpy(), np.asarray(want["final_pos"]))
