"""The port's gradient compression (`repro_torch.distributed.compression`)
and the compressed train step, on the CPU.

  * bitwise against the JAX package: `quantize_int8` / `dequantize_int8`
    at block 128 and 256, at sizes that are and are not a multiple of the
    block, with an all-zero block (the 1e-12 scale clamp); three steps of
    `ErrorFeedback.compress` over a small gradient dict; the reference's
    own compression tests on the port;
  * `compressed_psum_mean` on gloo at 1, 2 and 4 ranks (the ranks of
    `_torch_comm_worker.py`, started once by a module fixture): every
    rank's result bitwise a numpy version of the two-phase formula over the
    ranks' inputs, within half a quantization step of the true mean, and
    within 0.05 of it on the reference test's input (that test itself fails
    on this tree: ROADMAP C.4, so it is not the oracle);
  * `make_train_step(compress_pod_grads=True, pod_axis=group)` at 2 gloo
    ranks (reduced gemma3-1b, fp32, each rank its own batch): the
    parameters, moments and step after one step bitwise equal across the
    ranks, and bitwise `optimizer.apply` on the numpy formula of the two
    ranks' uncompressed gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as JC
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed import compression as C
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from _torch_gloo import COMP_CASES, STEP_ARCH, STEP_OPT, comp_input, run_ranks

WORLDS = (1, 2, 4)


def _blocks(x: np.ndarray, block: int) -> np.ndarray:
    flat = x.reshape(-1)
    return np.pad(flat, (0, (-flat.size) % block)).reshape(-1, block)


def psum_mean_formula(xs: list, block: int) -> tuple[np.ndarray, np.ndarray]:
    """The two-phase compressed mean in numpy: the ranks' per-block maxima
    -> one shared scale, each rank's int8 q, their int32 sum, dequantized
    and divided by the rank count (fp32 throughout); returns (the mean,
    the shared scales)."""
    blocks = [_blocks(x, block) for x in xs]
    amax = np.max([np.abs(b).max(axis=1, keepdims=True) for b in blocks], axis=0)
    scale = np.maximum(amax / np.float32(127), np.float32(1e-12))
    q_sum = sum(np.clip(np.round(b / scale), -127, 127).astype(np.int8).astype(np.int32)
                for b in blocks)
    out = (q_sum.astype(np.float32) * scale).reshape(-1)[: xs[0].size].reshape(xs[0].shape)
    return out / np.float32(len(xs)), scale


# ---------------------------------------------------------------------------
# quantize / dequantize and error feedback against the reference
# ---------------------------------------------------------------------------


def _input(shape, seed: int, zero_block: int = 0) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:zero_block] = 0.0
    return x


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("shape,zero", [((1000,), 0), ((4, 256), 0), ((3, 300), 1),
                                        ((7, 11, 5), 1)],
                         ids=["ragged", "whole", "zero-ragged", "zero-3d"])
def test_quantize_dequantize_bitwise_the_reference(shape, zero, block):
    x = _input(shape, 3, zero * block)
    q, s = C.quantize_int8(torch.from_numpy(x), block)
    jq, js = JC.quantize_int8(jnp.asarray(x), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if zero:
        assert float(s[0, 0]) == np.float32(1e-12) and not q[0].any()
    back = C.dequantize_int8(q, s, shape, block)
    np.testing.assert_array_equal(back.numpy(), np.asarray(JC.dequantize_int8(jq, js, shape, block)))


def test_error_feedback_bitwise_the_reference():
    grads = {"a": _input((7, 9), 5), "b": _input((300,), 6, 256)}
    resid = C.ErrorFeedback.init({k: torch.from_numpy(v) for k, v in grads.items()})
    jresid = JC.ErrorFeedback.init({k: jnp.asarray(v) for k, v in grads.items()})
    for step in range(3):
        g = {k: v * np.float32(step + 1) for k, v in grads.items()}
        sent, resid = C.ErrorFeedback.compress({k: torch.from_numpy(v) for k, v in g.items()}, resid)
        jsent, jresid = JC.ErrorFeedback.compress({k: jnp.asarray(v) for k, v in g.items()}, jresid)
        for k in grads:
            np.testing.assert_array_equal(sent[k].numpy(), np.asarray(jsent[k]))
            np.testing.assert_array_equal(resid[k].numpy(), np.asarray(jresid[k]))
    assert float(max(r.abs().max() for r in resid.values())) > 0


def test_quantize_roundtrip_accuracy():
    """The reference's `TestCompression.test_quantize_roundtrip_accuracy`
    on the port: the per-block error is at most scale / 2 = |max| / 254."""
    x = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0), (1000,))))
    q, s = C.quantize_int8(x, block=128)
    back = C.dequantize_int8(q, s, x.shape, block=128)
    assert float((back - x).abs().max()) < float(x.abs().max()) / 100.0


def test_error_feedback_unbiased():
    """The reference's `test_error_feedback_unbiased` on the port: a
    constant gradient is sent in full on average."""
    g = {"w": torch.tensor([0.001, -1.0, 0.5])}
    resid = C.ErrorFeedback.init(g)
    total = torch.zeros(3)
    for _ in range(50):
        sent, resid = C.ErrorFeedback.compress(g, resid)
        total = total + sent["w"]
    np.testing.assert_allclose((total / 50).numpy(), g["w"].numpy(), atol=1e-3)


# ---------------------------------------------------------------------------
# compressed_psum_mean and the compressed train step on gloo
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: every rank's arrays} of the compression suite."""
    return {w: run_ranks("compression", w, tmp_path_factory.mktemp(f"comp{w}")) for w in WORLDS}


@pytest.mark.parametrize("case", list(COMP_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_compressed_psum_mean_is_the_two_phase_formula(runs, world, case):
    shape, block = COMP_CASES[case]
    xs = [comp_input(case, r) for r in range(world)]
    want, scale = psum_mean_formula(xs, block)
    for r, arrays in enumerate(runs[world]):
        got = arrays[f"psum/{case}"]
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
    # within half a quantization step (of the shared scale) of the true mean
    err = np.abs(_blocks(want - np.mean(xs, axis=0, dtype=np.float64), block))
    assert (err <= scale * (0.5 + 1e-4)).all()
    if case == "reference-64":
        np.testing.assert_allclose(want, np.mean(xs, axis=0), atol=0.05)


def test_compressed_train_step_at_two_ranks(runs):
    a, b = runs[2]
    names = [k[len("param/"):] for k in a if k.startswith("param/")]
    for key in a:
        if not key.startswith("grad/"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert any(not np.array_equal(a[f"grad/{n}"], b[f"grad/{n}"]) for n in names)

    cfg = reduced(get_arch(STEP_ARCH))
    params = dict(T.init_params(cfg, seed=0, device="cpu").named_parameters())
    assert list(params) == names
    grads = {n: torch.from_numpy(psum_mean_formula([a[f"grad/{n}"], b[f"grad/{n}"]], 256)[0])
             for n in names}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' reductions ran on one thread
    try:
        _, state, _ = O.apply(O.AdamWConfig(**STEP_OPT), O.init(params), params, grads)
    finally:
        torch.set_num_threads(threads)
    assert int(state.step) == int(a["step"]) == 1
    for n in names:
        np.testing.assert_array_equal(a[f"param/{n}"], params[n].numpy(), err_msg=n)
        np.testing.assert_array_equal(a[f"mu/{n}"], state.mu[n].numpy(), err_msg=n)
        np.testing.assert_array_equal(a[f"nu/{n}"], state.nu[n].numpy(), err_msg=n)
