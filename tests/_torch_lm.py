"""Helpers of the port's LM tests: one reduced config's parameters on both
sides (the reference's `init_params`, carried across with
`convert.lm_params_from_jax`), batches of every modality from a numpy seed,
a prefill followed by greedy decode steps through both packages, and the
training loss and gradients through both."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import transformer as JT
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.models import transformer as T
from repro_torch.train import train_step as TS

RTOL, ATOL = 1e-4, 1e-4


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(), np.asarray(want), rtol=rtol, atol=atol)


def configs(name: str, **overrides):
    """(port, reference) reduced configs of one architecture."""
    return reduced(get_arch(name), **overrides), jreduced(jget_arch(name), **overrides)


def batch_for(cfg, seed: int, b: int, s: int) -> dict:
    """A numpy batch of `s` positions: (B, S) tokens, (B, S, ncb) for the
    audio frontend, or vision_tokens patch embeddings then S - vision_tokens
    text tokens."""
    rng = np.random.default_rng(seed)
    if cfg.modality == "audio_tokens":
        return {"tokens": rng.integers(0, cfg.vocab, (b, s, cfg.n_codebooks)).astype(np.int32)}
    if cfg.modality == "vision_text":
        return {
            "tokens": rng.integers(0, cfg.vocab, (b, s - cfg.vision_tokens)).astype(np.int32),
            "patch_embeds": rng.standard_normal((b, cfg.vision_tokens, cfg.vision_dim)).astype(
                np.float32),
        }
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def tbatch(batch: dict) -> dict:
    return {name: torch.from_numpy(a) for name, a in batch.items()}


def jbatch(batch: dict) -> dict:
    return {name: jnp.asarray(a) for name, a in batch.items()}


def prompt_of(batch: dict) -> dict:
    """The batch without its last token (its last text token for vision)."""
    return {name: a[:, :-1] if name == "tokens" else a for name, a in batch.items()}


def make_model(name: str, seed: int = 0, b: int = 2, s: int = 24, **overrides):
    """(cfg, params, jcfg, jparams, batch) at reduced() sizes, fp32."""
    cfg, jcfg = configs(name, **overrides)
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    params = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return cfg, params, jcfg, jparams, batch_for(cfg, seed + 7, b, s)


def layer_caches(jcaches, cfg) -> list:
    """The reference's [segment][pos]{name}[rep] caches, one entry a layer."""
    out = [None] * cfg.n_layers
    for seg, seg_map in zip(jcaches, T.segment_layers(cfg)):
        for entry, layers in zip(seg, seg_map):
            for rep, layer in enumerate(layers):
                out[layer] = {name: np.asarray(a[rep]) for name, a in entry.items()}
    return out


def decode_steps(model, s_max: int, steps: int = 3):
    """Prefill, then `steps` greedy decode steps on both sides, each taking
    the reference's argmax; yields the per-step (port, reference) logits,
    hidden states and caches."""
    cfg, params, jcfg, jparams, batch = model
    jpre = jax.jit(lambda p, bt: JT.prefill(p, jcfg, bt, s_max=s_max, act_dtype=jnp.float32,
                                            return_hidden=True))
    jdec = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jcfg, c, t, pos, act_dtype=jnp.float32,
                                                       return_hidden=True))
    jl, jc, jlen, jh = jpre(jparams, jbatch(batch))
    tl, tc, tlen, th = T.prefill(params, cfg, tbatch(batch), s_max=s_max, act_dtype=torch.float32,
                                 return_hidden=True)
    assert tlen == int(jlen)
    yield (tl, th, tc), (jl, jh, jc)
    b = batch["tokens"].shape[0]
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = np.full((b,), tlen, np.int32)
    for _ in range(steps):
        jl, jc, jh = jdec(jparams, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc, th = T.decode_step(params, cfg, tc, torch.from_numpy(tok), torch.from_numpy(pos),
                                   act_dtype=torch.float32, return_hidden=True)
        yield (tl, th, tc), (jl, jh, jc)
        tok, pos = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), pos + 1


def check_forward(model):
    """`forward`'s logits, hidden states and aux against the reference's."""
    cfg, params, jcfg, jparams, batch = model
    jfwd = jax.jit(lambda p, bt, h: JT.forward(p, jcfg, bt, act_dtype=jnp.float32, remat=False,
                                               return_hidden=h), static_argnames="h")
    for hidden in (False, True):
        got, aux = T.forward(params, cfg, tbatch(batch), act_dtype=torch.float32,
                             return_hidden=hidden)
        want, jaux = jfwd(jparams, jbatch(batch), hidden)
        assert got.shape == want.shape
        close(got, want)
        close(aux, jaux)


def check_prefill_and_decode(model, s_max: int):
    """Prefill and three decode steps: logits, hidden states and every
    layer's cache against the reference's."""
    cfg = model[0]
    for (tl, th, tc), (jl, jh, jc) in decode_steps(model, s_max):
        assert tl.shape == jl.shape and th.shape == (jl.shape[0], cfg.d_model)
        close(tl, jl)
        close(th, jh)
        for got, want in zip(tc, layer_caches(jc, cfg)):
            assert set(got) == set(want)
            for name in want:
                assert got[name].shape == want[name].shape, name
                close(got[name], want[name])


def check_decode_matches_forward(name: str, seed: int = 9):
    """The reference's `test_prefill_decode_matches_forward` on the port:
    prefill all but the last token, decode it, against the forward's last
    position (MoE capacity 16: no drops), rtol / atol 5e-3."""
    cfg = reduced(get_arch(name), moe_capacity_factor=16.0)
    params = T.init_params(cfg, seed=seed, device="cpu")
    batch = tbatch(batch_for(cfg, seed, 2, 24))
    full, _ = T.forward(params, cfg, batch, act_dtype=torch.float32)
    _, caches, plen = T.prefill(params, cfg, prompt_of(batch), s_max=26, act_dtype=torch.float32)
    pos = torch.full((2,), plen, dtype=torch.int32)
    dec, _ = T.decode_step(params, cfg, caches, batch["tokens"][:, -1], pos,
                           act_dtype=torch.float32)
    close(dec, full[:, -1], 5e-3, 5e-3)


GRAD_LOSS_TOL, GRAD_TOL, GRAD_CE_CHUNK = 1e-5, 1e-4, 8


def check_loss_and_grads(name: str, capacity=None):
    """The port's loss, CE, MoE aux and every gradient leaf against
    `jax.value_and_grad(repro.train.train_step.loss_fn)` on the same
    parameters and batch (reduced config, fp32, CE chunks of 8): the loss
    terms within GRAD_LOSS_TOL absolute, each leaf (in the reference's
    structure and flatten order, by `convert.lm_params_to_jax`) within
    GRAD_TOL of the largest magnitude of the reference's leaf."""
    overrides = {} if capacity is None else {"moe_capacity_factor": capacity}
    cfg, params, jcfg, jparams, batch = make_model(name, b=2, s=24, **overrides)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JTS.loss_fn(p, jcfg, b, act_dtype=jnp.float32, ce_chunk=GRAD_CE_CHUNK),
        has_aux=True))
    (jloss, jaux), jgrads = vg(jparams, jbatch(batch))
    loss, aux, grads = TS.loss_and_grads(params, cfg, tbatch(batch), act_dtype=torch.float32,
                                         ce_chunk=GRAD_CE_CHUNK)

    assert abs(float(loss) - float(jloss)) <= GRAD_LOSS_TOL
    assert abs(float(aux["ce"]) - float(jaux["ce"])) <= GRAD_LOSS_TOL
    assert abs(float(aux["moe_aux"]) - float(jaux["moe_aux"])) <= GRAD_LOSS_TOL
    if cfg.n_experts:
        assert float(jaux["moe_aux"]) > 0
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jgrads))
    got = jax.tree_util.tree_leaves_with_path(convert.lm_params_to_jax(grads, cfg))
    keystr = jax.tree_util.keystr
    assert [keystr(p) for p, _ in got] == [keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all(), keystr(path)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * scale + 1e-12, (keystr(path), err, scale)
