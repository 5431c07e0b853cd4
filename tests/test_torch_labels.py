"""repro_torch.core.labels against repro.core.labels on the same inputs.

Packing and the predicate test are integer work, so every word, mask and
id agrees exactly, label ids 31, 63 and 95 (the int32 sign bit) and -1
(unlabeled) included. `filtered_brute_force` ranks pairwise distances whose
fp32 sums may differ in the last bit, so its sets agree except at
near-ties: at least 99% of truth entries are shared, and recall scored on
the same ids is equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import labels as JL
from repro_torch.core import labels as L

torch.set_num_threads(1)


def _np(t) -> np.ndarray:
    return np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)


@pytest.mark.parametrize("n_labels", [1, 31, 32, 33, 64, 100])
def test_pack_bits_equals_reference(n_labels):
    member = np.random.default_rng(n_labels).random((40, n_labels)) < 0.3
    member[0, :] = True  # every bit, the sign bits among them
    want = _np(JL.pack_bits(jnp.asarray(member)))
    got = L.pack_bits(member)
    assert got.dtype == torch.int32 and got.shape == (40, L.n_words(n_labels))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pack_ids_on_the_sign_bit_equals_reference():
    ids = np.array([0, 31, 32, 63, 64, 95, -1, 5, 99], np.int32)
    want = _np(JL.pack_ids(jnp.asarray(ids), 100))
    got = L.pack_ids(ids, 100)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[1, 0]) == int(got[3, 1]) == -(2**31)
    assert not got[6].any()
    member = np.zeros((9, 100), bool)
    member[np.arange(9)[ids >= 0], ids[ids >= 0]] = True
    np.testing.assert_array_equal(L.pack_bits(member).numpy(), got.numpy())


def test_query_words_forms_equal_reference():
    rng = np.random.default_rng(2)
    w = L.n_words(70)
    ids = rng.integers(-1, 70, 12).astype(np.int32)
    member = rng.random((12, 70)) < 0.2
    packed = _np(JL.pack_bits(jnp.asarray(member)))
    for form in (ids, member, packed):
        want = _np(JL.query_words(jnp.asarray(form), w))
        np.testing.assert_array_equal(L.query_words(form, w).numpy(), want)
    # a narrower mask is padded to the store's W
    np.testing.assert_array_equal(
        L.query_words(member[:, :20], w).numpy(), _np(JL.query_words(jnp.asarray(member[:, :20]), w))
    )
    with pytest.raises(ValueError):
        L.query_words(packed[:, :2], w)
    with pytest.raises(ValueError):
        L.query_words(rng.random((3, 200)) < 0.5, w)


def test_encode_labels_and_label_sets_equal_reference():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 40, 300).astype(np.int32)
    store = L.encode_labels(labels, 70)
    want = JL.encode_labels(jnp.asarray(labels), 70)
    np.testing.assert_array_equal(store.words.numpy(), _np(want.words))
    np.testing.assert_array_equal(store.labels.numpy(), labels)
    assert (store.n, store.w, store.capacity) == (300, 3, 96)
    assert L.encode_labels(labels).w == JL.encode_labels(jnp.asarray(labels)).w == 2
    with pytest.raises(ValueError):
        L.encode_labels(np.array([40], np.int32), 33)
    member = rng.random((300, 50)) < 0.1
    sets = L.encode_label_sets(member)
    assert sets.labels is None
    np.testing.assert_array_equal(
        sets.words.numpy(), _np(JL.encode_label_sets(jnp.asarray(member)).words)
    )
    assert L.store_words(sets) is sets.words
    np.testing.assert_array_equal(L.store_words(_np(sets.words)).numpy(), sets.words.numpy())


@pytest.fixture(scope="module")
def labeled():
    rng = np.random.default_rng(4)
    n, q, n_labels = 600, 40, 70
    x = rng.standard_normal((n, 16)).astype(np.float32)
    queries = rng.standard_normal((q, 16)).astype(np.float32)
    vwords = _np(JL.pack_ids(jnp.asarray(rng.integers(-1, n_labels, n).astype(np.int32)), n_labels))
    fwords = np.array(JL.random_query_filters(jax.random.PRNGKey(5), q, n_labels, 0.1))
    # a single allowed label (~8 rows of 600) for the first ten queries
    fwords[:10] = _np(JL.pack_ids(jnp.arange(10, dtype=jnp.int32) * 7, n_labels))
    ids = rng.integers(-1, n, (q, 12)).astype(np.int32)
    return x, queries, vwords, fwords, ids


def test_allowed_mask_and_predicate_fraction_equal_reference(labeled):
    _, _, vwords, fwords, ids = labeled
    want = _np(JL.allowed_mask(jnp.asarray(ids), jnp.asarray(fwords), jnp.asarray(vwords)))
    got = L.allowed_mask(ids, torch.from_numpy(fwords), torch.from_numpy(vwords))
    np.testing.assert_array_equal(got.numpy(), want)
    # the reference divides in fp32, the port in Python floats
    frac = JL.predicate_fraction(jnp.asarray(ids), jnp.asarray(fwords), jnp.asarray(vwords))
    got_frac = L.predicate_fraction(ids, torch.from_numpy(fwords), torch.from_numpy(vwords))
    assert 0 < got_frac < 1 and abs(got_frac - frac) <= 1e-6
    empty = np.full((3, 4), -1, np.int32)
    assert L.predicate_fraction(empty, torch.from_numpy(fwords[:3]), torch.from_numpy(vwords)) == 1.0


def test_filtered_brute_force_and_recall_equal_reference(labeled):
    x, queries, vwords, fwords, _ = labeled
    want = _np(
        JL.filtered_brute_force(
            jnp.asarray(x), jnp.asarray(queries), jnp.asarray(fwords), jnp.asarray(vwords), 10,
            chunk=16,
        )
    )
    got = L.filtered_brute_force(
        torch.from_numpy(x), torch.from_numpy(queries), torch.from_numpy(fwords),
        torch.from_numpy(vwords), 10, chunk=16,
    ).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got < 0, want < 0)  # the allowed counts agree
    shared = sum(len(set(a[a >= 0]) & set(b[b >= 0])) for a, b in zip(got, want))
    assert shared >= 0.99 * (want >= 0).sum()
    assert (got < 0).any()  # some queries allow fewer than k rows
    allowed = L.allowed_mask(got, torch.from_numpy(fwords), torch.from_numpy(vwords)).numpy()
    assert allowed[got >= 0].all()
    found = np.where(np.random.default_rng(6).random(got.shape) < 0.7, got, -1)
    assert L.filtered_recall_at_k(found, got) == JL.filtered_recall_at_k(found, got)


@pytest.mark.parametrize("sel,n_labels", [(0.01, 100), (0.1, 100), (0.5, 100), (0.3, 33)])
def test_random_query_filters_allow_the_stated_share(sel, n_labels):
    g = torch.Generator().manual_seed(7)
    fw = L.random_query_filters(g, 50, n_labels, sel)
    assert fw.dtype == torch.int32 and fw.shape == (50, L.n_words(n_labels))
    bits = ((fw[:, :, None] >> torch.arange(32, dtype=torch.int32)) & 1).reshape(50, -1)
    assert (bits.sum(1) == max(1, round(sel * n_labels))).all()
    assert not bits[:, n_labels:].any()  # nothing outside the label space
    again = L.random_query_filters(torch.Generator().manual_seed(7), 50, n_labels, sel)
    assert torch.equal(fw, again)
