"""repro_torch.core.vecstore against repro.core.vecstore on identical numpy data.

Tolerances:
  * int8 scale / offset: equal (the same per-dimension min and max, then the
    same fp32 operations);
  * int8 codes: equal except at a rounding midpoint, where (x - offset) /
    scale sits within 1e-4 of k + 0.5 (XLA and PyTorch may round the
    quotient differently there);
  * dequantized rows of the same codes (requant, dequant): rtol 1e-6, atol
    1e-6, a few ulps of unit-scale values (XLA may fuse `q * scale + offset`
    into one multiply-add; the port never does);
  * bf16 encode: bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vecstore as jvs
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import vecstore as VS
from repro_torch.data import synthetic
from repro_torch.kernels import ref

# the suite runs in parallel workers: one intra-op thread each keeps torch
# from oversubscribing the cores the JAX tests share
torch.set_num_threads(1)

ROW_RTOL, ROW_ATOL = 1e-6, 1e-6


def _data(preset, n, seed=0):
    """A preset's rows from a seed (drawn once, handed to both packages)."""
    return synthetic.make_preset(torch.Generator().manual_seed(seed), preset, n).numpy()


def _assert_codes_match(x, got, want, scale, offset):
    """int8 codes equal, except at rounding midpoints."""
    t = (x.astype(np.float64) - offset.astype(np.float64)) / scale.astype(np.float64)
    midpoint = np.abs(np.abs(t - np.floor(t)) - 0.5) < 1e-4
    bad = (got != want) & ~midpoint
    assert not bad.any(), f"int8 codes differ away from a midpoint at {np.argwhere(bad)[:5]}"
    assert (np.abs(got.astype(np.int32) - want.astype(np.int32)) <= 1).all()


@pytest.mark.parametrize("preset,n", [("sift-like", 500), ("deep-like", 300), ("tiny", 64)])
def test_quantize_int8_matches_jax(preset, n):
    x = _data(preset, n)
    x[:, 3] = 0.25  # a constant dimension: scale 1, every code 0
    want = jvs.quantize_int8(jnp.asarray(x))
    got = VS.quantize_int8(torch.from_numpy(x))
    assert got.precision == "int8" and got.data.dtype == torch.int8
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.offset.numpy(), np.asarray(want.offset))
    assert got.scale[3] == 1.0 and (got.data[:, 3] == 0).all()
    _assert_codes_match(x, got.data.numpy(), np.asarray(want.data), *map(np.asarray, want[1:]))
    # the round trip stays within half a step of the input
    err = (got.dequant() - torch.from_numpy(x)).abs()
    assert (err <= got.scale / 2 + 1e-6).all()


def test_quantize_int8_empty_corpus():
    got = VS.quantize_int8(torch.zeros((0, 7)))
    want = jvs.quantize_int8(jnp.zeros((0, 7)))
    assert tuple(got.data.shape) == (0, 7) and got.data.dtype == torch.int8
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.offset.numpy(), np.asarray(want.offset))


def test_encode_float_rungs_match_jax_bit_for_bit():
    x = _data("sift-like", 200)
    got = VS.encode(torch.from_numpy(x), "bf16")
    jdata = np.asarray(jvs.encode(jnp.asarray(x), "bf16").data)
    want = convert.store_from_jax(jdata, device="cpu")
    assert got.precision == "bf16" and got.scale is None
    assert torch.equal(got.data.view(torch.int16), want.data.view(torch.int16))
    f32 = VS.encode(torch.from_numpy(x), "fp32")
    assert f32.precision == "fp32" and torch.equal(f32.data, torch.from_numpy(x))
    with pytest.raises(ValueError, match="precision"):
        VS.encode(torch.from_numpy(x), "fp16")


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_quantize_rows_and_requant_match_jax(precision):
    x = _data("sift-like", 400)
    new = _data("sift-like", 50, seed=3) * 1.5  # partly outside the encode range: clips
    jstore = jvs.encode(jnp.asarray(x[:300]), precision)
    store = convert.store_from_jax(
        *(None if a is None else np.asarray(a) for a in jstore), device="cpu"
    )
    codes = store.quantize_rows(torch.from_numpy(new))
    want = np.asarray(jstore.quantize_rows(jnp.asarray(new)))
    if precision == "int8":
        _assert_codes_match(new, codes.numpy(), want, *map(np.asarray, jstore[1:]))
        assert codes.abs().max() == 127  # the out-of-range rows clipped
    else:
        got = codes.view(torch.int16) if precision == "bf16" else codes
        exp = convert.store_from_jax(want, device="cpu").data
        assert torch.equal(got, exp.view(torch.int16) if precision == "bf16" else exp)
    # requant is the dequant of those codes (held against the JAX formula on
    # the same codes, so a midpoint code cannot move the comparison)
    got = store.requant(torch.from_numpy(new))
    assert torch.equal(got, ref.dequant_rows(codes, store.scale, store.offset))
    jcodes = jnp.asarray(codes.float().numpy()).astype(jstore.data.dtype)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jref.dequant_rows(jcodes, jstore.scale, jstore.offset)),
        rtol=ROW_RTOL,
        atol=ROW_ATOL,
    )
    np.testing.assert_allclose(
        store.dequant().numpy(), np.asarray(jstore.dequant()), rtol=ROW_RTOL, atol=ROW_ATOL
    )


def test_store_methods():
    x = torch.from_numpy(_data("sift-like", 100))
    s = VS.encode(x, "int8")
    assert (s.n, s.dim, s.shape, s.device.type) == (100, 128, (100, 128), "cpu")
    assert s.bytes_per_vector() == 128.0
    assert s.bytes_per_vector(include_overhead=True) == 128.0 + 8.0 * 128 / 100
    assert VS.encode(x, "bf16").bytes_per_vector(True) == 256.0
    idx = torch.tensor([[3, 7], [0, 99]])
    assert torch.equal(s.take(idx), s.dequant()[idx])
    assert torch.equal(s.dequant(), ref.dequant_rows(s.data, s.scale, s.offset))
    # with_rows writes the encoded rows in place and returns the store
    new = x[:2] * 0.5
    out = s.with_rows(torch.tensor([10, 20]), new)
    assert out is s and torch.equal(s.data[[10, 20]], s.quantize_rows(new))


def test_store_or_tensor_helpers():
    x = torch.from_numpy(_data("tiny", 30))
    s = VS.encode(x, "int8")
    idx = torch.tensor([1, 2])
    assert VS.as_store(s) is s and VS.as_store(x).precision == "fp32"
    assert VS.parts(x) == (x, None, None) and VS.parts(s) == tuple(s)
    assert VS.nrows(s) == VS.nrows(x) == 30 and VS.dim(s) == VS.dim(x) == 16
    assert torch.equal(VS.take(s, idx), s.take(idx)) and torch.equal(VS.take(x, idx), x[idx])
    assert torch.equal(VS.dequant(s), s.dequant()) and torch.equal(VS.dequant(x), x)
    assert [VS.precision_of(a) for a in (x, s, x.bfloat16())] == ["fp32", "int8", "bf16"]
    assert VS.PRECISIONS == jvs.PRECISIONS
    # to_device keeps a store's rung and a stored dtype; arrays become fp32
    dev = torch.device("cpu")
    assert VS.to_device(s, dev).precision == "int8"
    assert VS.to_device(x.bfloat16(), dev).dtype == torch.bfloat16
    assert VS.to_device(np.zeros((2, 3)), dev).dtype == torch.float32


def test_store_from_jax_carries_every_rung():
    x = _data("sift-like", 64)
    for precision in ("fp32", "bf16", "int8"):
        j = jvs.encode(jnp.asarray(x), precision)
        s = convert.store_from_jax(*(None if a is None else np.asarray(a) for a in j), device="cpu")
        assert s.precision == precision
        np.testing.assert_array_equal(s.data.float().numpy(), np.asarray(j.data, np.float32))
        np.testing.assert_allclose(
            s.dequant().numpy(), np.asarray(j.dequant()), rtol=ROW_RTOL, atol=ROW_ATOL
        )
