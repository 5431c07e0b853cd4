"""The port's training (`repro_torch.train`, `data.pipeline`,
`checkpoint.checkpoint`, `launch.train`) against the JAX package, on the
CPU.

  * remat: `remat=False` and `remat_policy="full"` give bitwise the same
    loss and gradients; `"dots"` within 1e-6 of the leaf's largest
    magnitude (it recomputes the same ops);
  * the chunked CE: chunks of 5 (a ragged last chunk) against one chunk
    within 1e-6;
  * AdamW: one and two `apply`s against `repro.train.optimizer.apply` on
    the same parameters and gradients, one of them clipped: parameters and
    moments within rtol 1e-6 / atol 1e-7 (fp32, one rounding of the last
    bit), step and grad norm likewise; `schedule` at warmup, the peak and
    the end within 1e-7; the reference's own optimizer tests on the port;
  * one train step (two microbatches) against `repro`'s `make_train_step`
    from the same parameters and batch: loss within 1e-5, the moments
    within 1e-4 of each leaf's largest magnitude, the parameters within
    2 x lr and all but 1 in 1,000 elements within 1e-6 (the first step's
    g / |g| at noise-level gradients); four microbatches against the whole
    batch (`test_microbatch_equivalence`'s tolerances: loss rel 1e-4,
    parameters rtol 1e-4 / atol 1e-5);
  * checkpoints: round trip, `latest_step` and `prune_old`, the atomic
    commit; a train state written by `repro.checkpoint.save` restores in
    the port and one written by the port restores through
    `repro.checkpoint.restore`, leaves equal both ways, and both manifests
    are equal (paths, shapes, dtypes);
  * the loop: resumed training bitwise equal to uninterrupted training
    (gemma3-1b reduced, 20 steps, preempted at 10); mamba2-130m's loss
    falls by more than 0.3 over 60 steps (the reference's margins); the
    CLI with `--device cpu`; `device="cuda"` raises without a card;
  * the pipeline: deterministic per step, different between steps, every
    modality's shapes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JCK
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as CK
from repro_torch.configs import get_arch, reduced
from repro_torch.data import pipeline as PIPE
from repro_torch.launch import train as LT
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS
from _torch_lm import batch_for, jbatch, make_model, tbatch

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# remat and the chunked CE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["gemma3-1b", "deepseek-moe-16b", "zamba2-7b"])
def test_remat_full_is_bitwise_no_remat_and_dots_within_tolerance(name):
    cfg = reduced(get_arch(name))
    params = T.init_params(cfg, seed=3, device="cpu")
    batch = tbatch(batch_for(cfg, 4, 2, 24))

    def grads(**kw):
        return TS.loss_and_grads(params, cfg, batch, act_dtype=torch.float32, **kw)

    base = grads(remat=False)
    full = grads(remat=True, remat_policy="full")
    dots = grads(remat=True, remat_policy="dots")
    assert torch.equal(base[0], full[0])
    for n, g in base[2].items():
        assert torch.equal(g, full[2][n]), n
        scale = float(g.abs().max())
        assert float((dots[2][n] - g).abs().max()) <= 1e-6 * scale + 1e-12, n
    with pytest.raises(ValueError):
        grads(remat_policy="everything")


def test_ce_chunks_agree_with_one_chunk():
    cfg = reduced(get_arch("gemma2-2b"))  # logit softcap on
    params = T.init_params(cfg, seed=1, device="cpu")
    batch = tbatch(batch_for(cfg, 2, 3, 17))
    one, _ = TS.loss_fn(params, cfg, batch, act_dtype=torch.float32, ce_chunk=512)
    ragged, _ = TS.loss_fn(params, cfg, batch, act_dtype=torch.float32, ce_chunk=5)
    assert abs(float(one) - float(ragged)) <= 1e-6


def test_ce_masks_negative_targets():
    cfg = reduced(get_arch("gemma3-1b"))
    params = T.init_params(cfg, seed=2, device="cpu")
    h = torch.randn((2, 6, cfg.d_model), generator=torch.Generator().manual_seed(0))
    t = torch.randint(0, cfg.vocab, (2, 6), generator=torch.Generator().manual_seed(1))
    masked = t.clone()
    masked[:, 3:] = -1
    got = TS._ce_from_hidden(params, cfg, h, masked, chunk=4)
    want = TS._ce_from_hidden(params, cfg, h[:, :3], t[:, :3], chunk=4)
    assert abs(float(got) - float(want)) <= 1e-6


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": (scale * rng.standard_normal((4, 5))).astype(np.float32),
            "b": (scale * rng.standard_normal((7,))).astype(np.float32)}


def _t(tree: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _close(got: dict, want: dict, rtol=1e-6, atol=1e-7):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=atol)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_adamw_apply_matches_reference(grad_scale):
    cfg = O.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg = JO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    p0, g1, g2 = _tree(0), _tree(1, grad_scale), _tree(2, grad_scale)
    params = _t(p0)
    state = O.init(params)
    jp, jstate = {k: jnp.asarray(v) for k, v in p0.items()}, JO.init(p0)
    for g in (g1, g2):
        params, state, m = O.apply(cfg, state, params, _t(g))
        jp, jstate, jm = JO.apply(jcfg, jstate, jp, {k: jnp.asarray(v) for k, v in g.items()})
        _close(params, jp)
        _close(state.mu, jstate.mu)
        _close(state.nu, jstate.nu)
        assert int(state.step) == int(jstate.step)
        assert state.mu["a"].dtype == torch.float32
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    if grad_scale > 1:
        assert float(m["grad_norm"]) > cfg.clip_norm  # the pre-clip norm is reported


def test_schedule_matches_reference():
    cfg = O.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    jcfg = JO.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step in (0, 5, 10, 37, 100, 150):
        got = float(O.schedule(cfg, torch.tensor(step)))
        assert got == pytest.approx(float(JO.schedule(jcfg, jnp.asarray(step))), abs=1e-7)
    assert float(O.schedule(cfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(O.schedule(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(O.schedule(cfg, torch.tensor(100))) == pytest.approx(0.1)


def test_adamw_reduces_quadratic_and_reports_preclip_norm():
    params = {"w": torch.tensor([3.0, -2.0, 1.0])}
    cfg = O.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1, total_steps=200)
    state = O.init(params)
    for _ in range(150):
        params, state, _ = O.apply(cfg, state, params, {"w": 2 * params["w"]})
    assert float(params["w"].abs().max()) < 0.1
    params = {"w": torch.zeros(3)}
    _, _, m = O.apply(O.AdamWConfig(clip_norm=1.0), O.init(params), params,
                      {"w": torch.full((3,), 100.0)})
    assert float(m["grad_norm"]) > 100.0


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _state(params) -> TS.TrainState:
    return TS.TrainState(params, O.init(dict(params.named_parameters())))


def test_train_step_matches_reference():
    """The first AdamW step moves each parameter by about lr * g / |g|, so
    an element whose gradient lies near the fp32 noise floor (where XLA's
    and PyTorch's sums differ in relative terms) moves by a share of lr
    that rounding decides: the parameters are held within 2 * lr, and all
    but 1 in 1,000 elements within 1e-6; the moments, linear in the
    gradients, within 1e-4 of each leaf's largest magnitude."""
    cfg, params, jcfg, jparams, batch = make_model("gemma3-1b", b=4, s=24)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(JTS.make_train_step(jcfg, JO.AdamWConfig(**opt), microbatches=2,
                                        act_dtype=jnp.float32, ce_chunk=8))
    jstate, jm = jstep(JTS.TrainState(jparams, JO.init(jparams)), jbatch(batch))
    step = TS.make_train_step(cfg, O.AdamWConfig(**opt), microbatches=2, act_dtype=torch.float32,
                              ce_chunk=8)
    state, m = step(_state(params), tbatch(batch))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    got = convert.train_state_to_jax(state, cfg)
    want = jax.tree.map(np.asarray, jstate)
    assert int(got.opt.step) == int(want.opt.step) == 1
    moved, n = 0, 0
    for g, w in zip(jax.tree.leaves(got.params), jax.tree.leaves(want.params)):
        err = np.abs(g - w)
        assert float(err.max()) <= 2 * opt["lr"]
        moved, n = moved + int((err > 1e-6).sum()), n + err.size
    assert moved <= 1e-3 * n, (moved, n)
    for tree in ("mu", "nu"):
        for g, w in zip(jax.tree.leaves(getattr(got.opt, tree)),
                        jax.tree.leaves(getattr(want.opt, tree))):
            assert float(np.abs(g - w).max()) <= 1e-4 * float(np.abs(w).max()) + 1e-20
    assert not any(p.requires_grad for p in state.params.parameters())


def test_microbatch_equivalence():
    cfg = reduced(get_arch("h2o-danube-1.8b"))
    opt_cfg = O.AdamWConfig(lr=1e-3)
    batch = PIPE.batch_for_step(cfg, 0, 8, 32, device="cpu")
    s1 = _state(T.init_params(cfg, seed=0, device="cpu"))
    s2 = _state(T.init_params(cfg, seed=0, device="cpu"))
    f1 = TS.make_train_step(cfg, opt_cfg, microbatches=1, act_dtype=torch.float32)
    f2 = TS.make_train_step(cfg, opt_cfg, microbatches=4, act_dtype=torch.float32)
    s1, m1 = f1(s1, batch)
    s2, m2 = f2(s2, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    for (n, x), (_, y) in zip(s1.params.named_parameters(), s2.params.named_parameters()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4, atol=1e-5, err_msg=n)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _small(k: int = 0) -> dict:
    return {"a": np.arange(6.0).reshape(2, 3) + k, "b": {"c": np.asarray(7 + k),
                                                       "d": np.ones((4,)) * k}}


def test_checkpoint_roundtrip(tmp_path):
    t = _small(3)
    CK.save(tmp_path, 12, t)
    got = CK.restore(tmp_path, 12, t)
    jax.tree.map(np.testing.assert_array_equal, got, t)
    with pytest.raises(ValueError):
        CK.restore(tmp_path, 12, {"a": np.zeros((3, 2)), "b": t["b"]})


def test_checkpoint_latest_and_prune(tmp_path):
    for s in (1, 5, 9, 13):
        CK.save(tmp_path, s, _small(s))
    assert CK.latest_step(tmp_path) == 13
    CK.prune_old(tmp_path, keep=2)
    assert CK.latest_step(tmp_path) == 13
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000000009", "step_000000013"]
    with pytest.raises(FileNotFoundError):
        CK.restore(tmp_path, 1, _small())
    assert CK.latest_step(tmp_path / "absent") is None


def test_checkpoint_atomic_commit_no_partial(tmp_path):
    CK.save(tmp_path, 2, _small())
    CK.save(tmp_path, 2, _small(1))  # a re-save replaces the committed step
    assert [p.name for p in tmp_path.iterdir()] == ["step_000000002"]
    jax.tree.map(np.testing.assert_array_equal, CK.restore(tmp_path, 2, _small()), _small(1))


@pytest.mark.parametrize("name", ["gemma3-1b", "zamba2-7b", "internvl2-2b", "musicgen-large",
                                  "deepseek-moe-16b"])
def test_checkpoints_restore_across_packages(tmp_path, name):
    cfg, params, jcfg, jparams, _ = make_model(name)
    # moments drawn from a seed and a step of 1, so no leaf is a zero
    rng = np.random.default_rng(11)

    def drawn(p):
        return jnp.asarray(rng.standard_normal(p.shape).astype(np.float32))

    jstate = JTS.TrainState(jparams, JO.AdamWState(jnp.asarray(1, jnp.int32),
                                                   jax.tree.map(drawn, jparams),
                                                   jax.tree.map(drawn, jparams)))
    JCK.save(tmp_path / "ref", 1, jstate)
    like = convert.train_state_to_jax(_state(params), cfg)
    state = convert.train_state_from_jax(CK.restore(tmp_path / "ref", 1, like), cfg, device="cpu")
    assert int(state.opt.step) == 1
    for got, want in zip(jax.tree.leaves(convert.train_state_to_jax(state, cfg)),
                         jax.tree.leaves(jax.tree.map(np.asarray, jstate))):
        np.testing.assert_array_equal(got, want)

    CK.save(tmp_path / "port", 1, convert.train_state_to_jax(state, cfg))
    back = JCK.restore(tmp_path / "port", 1, jax.eval_shape(lambda: jstate))
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(got, want)
    manifests = [json.loads((tmp_path / d / "step_000000001" / "manifest.json").read_text())
                 for d in ("ref", "port")]
    assert manifests[0] == manifests[1]


# ---------------------------------------------------------------------------
# the training loop and the pipeline
# ---------------------------------------------------------------------------


def test_checkpoint_resume_bit_exact(tmp_path):
    kw = dict(steps=20, batch=2, seq=32, save_every=10, device="cpu")
    a, _ = LT.train("gemma3-1b", ckpt_dir=str(tmp_path / "a"), **kw)
    LT.train("gemma3-1b", stop_at=10, ckpt_dir=str(tmp_path / "b"), **kw)
    b, _ = LT.train("gemma3-1b", ckpt_dir=str(tmp_path / "b"), **kw)
    assert int(a.opt.step) == int(b.opt.step) == 20
    for (n, x), (_, y) in zip(a.params.named_parameters(), b.params.named_parameters()):
        assert torch.equal(x, y), n
    for n, x in a.opt.nu.items():
        assert torch.equal(x, b.opt.nu[n]), n


def test_loss_decreases_tiny_lm():
    _, hist = LT.train("mamba2-130m", steps=60, batch=4, seq=64, log_every=5, lr=3e-3,
                       device="cpu")
    first, last = hist[0]["loss"], hist[-1]["loss"]
    assert last < first - 0.3, (first, last)


def test_train_cli_on_cpu_and_the_card_default(tmp_path, capsys):
    out = tmp_path / "hist.json"
    LT.main(["--arch", "gemma2-2b", "--steps", "3", "--batch", "2", "--seq", "16",
             "--device", "cpu", "--out", str(out)])
    hist = json.loads(out.read_text())
    assert [h["step"] for h in hist] == [1] and np.isfinite(hist[0]["loss"])
    assert "step     1  loss" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            LT.train("gemma2-2b", steps=1)


def test_pipeline_deterministic_per_step():
    cfg = reduced(get_arch("gemma2-2b"))
    b1 = PIPE.batch_for_step(cfg, 7, 4, 32, device="cpu")
    b2 = PIPE.batch_for_step(cfg, 7, 4, 32, device="cpu")
    b3 = PIPE.batch_for_step(cfg, 8, 4, 32, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    stream = PIPE.stream(cfg, 4, 32, start_step=7, device="cpu")
    assert torch.equal(next(stream)["tokens"], b1["tokens"])
    assert torch.equal(next(stream)["tokens"], b3["tokens"])


@pytest.mark.parametrize("name", ["gemma3-1b", "musicgen-large", "internvl2-2b"])
def test_pipeline_modalities(name):
    cfg = reduced(get_arch(name))
    b = PIPE.batch_for_step(cfg, 0, 3, 24, seed=5, device="cpu")
    toks = b["tokens"]
    assert toks.dtype == torch.int32 and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab
    if cfg.modality == "audio_tokens":
        assert toks.shape == (3, 24, cfg.n_codebooks)
    elif cfg.modality == "vision_text":
        assert toks.shape == (3, 24 - cfg.vision_tokens)
        assert b["patch_embeds"].shape == (3, cfg.vision_tokens, cfg.vision_dim)
        assert 0.05 < float(b["patch_embeds"].std()) < 0.2
    else:
        assert toks.shape == (3, 24)
    params = T.init_params(cfg, seed=0, device="cpu")
    loss, _ = TS.loss_fn(params, cfg, b, act_dtype=torch.float32)
    assert bool(torch.isfinite(loss))
