"""Label store and packed predicate words for filtered search.

A port of the JAX package's `core/labels.py`. Filtered search returns the
nearest neighbors among the vectors that match a per-query predicate:

  * **vertex side** — `LabelStore`: a per-vertex label (one categorical
    label per vertex, -1 = unlabeled) packed into an (N, W) int32 bitset,
    bit `l % 32` of word `l // 32` meaning "carries label l",
    W = ceil(n_labels / 32). Multi-label vertices pack the same way from an
    (N, L) membership mask (`encode_label_sets`). The label space, and so
    W, is frozen at encode time, like the quantizer's scale / offset.
  * **query side** — a (Q, W) int32 allowed-bitset: query q may return
    vertex v iff `any(words[v] & allowed[q] != 0)`. `query_words` turns the
    accepted predicate forms (a (Q,) allowed label id, a (Q, L) bool label
    mask, or packed (Q, W) words) into that one operand.

The test is pure int32 bitwise work, so the kernel's `allowed` output and
the plain version's agree exactly on every storage rung. Label ids 31, 63,
... land on the int32 sign bit: words are built with int32 shifts and ORs,
never a sum that could promote to int64.

Semantics are route-through: a filtered-out vertex stays traversable (in
the beam, with its real distance) and is only kept out of the result heap
(`core/search.py`), unlike the tombstone mask, which removes a vertex from
traversal.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops

WORD_BITS = 32


def _tensor(a, dtype: torch.dtype | None = None) -> torch.Tensor:
    """`a` (a tensor, or anything `np.array` takes) as a tensor, keeping a
    tensor's device."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def n_words(n_labels: int) -> int:
    """Packed words per bitset row for an `n_labels`-wide label space."""
    return max(1, -(-int(n_labels) // WORD_BITS))


def _bit(pos: torch.Tensor) -> torch.Tensor:
    """int32 1 << pos for pos in [0, 32): position 31 is -2^31."""
    return torch.ones_like(pos, dtype=torch.int32) << pos.to(torch.int32)


def pack_bits(member) -> torch.Tensor:
    """(B, L) bool label-membership mask -> (B, W) packed int32 words.

    Bit `l % 32` of word `l // 32` is membership in label l; the words are
    OR-reduced in int32, so bit 31 is the sign bit and nothing promotes.
    """
    member = _tensor(member, torch.bool)
    b, n = member.shape
    w = n_words(n)
    pad = w * WORD_BITS - n
    if pad:
        member = torch.nn.functional.pad(member, (0, pad))
    bits = member.reshape(b, w, WORD_BITS).to(torch.int32)
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=member.device)
    shifted = bits << shifts
    out = torch.zeros((b, w), dtype=torch.int32, device=member.device)
    for i in range(WORD_BITS):
        out |= shifted[:, :, i]
    return out


def pack_ids(ids, n_labels: int) -> torch.Tensor:
    """(B,) int32 label ids -> (B, W) one-hot packed words; id -1 -> all
    zeros (an unlabeled vertex, or a predicate that matches nothing)."""
    ids = _tensor(ids, torch.int32)
    w = n_words(n_labels)
    safe = ids.clamp_min(0)
    rows = torch.zeros((ids.shape[0], w), dtype=torch.int32, device=ids.device)
    rows.scatter_(1, (safe // WORD_BITS).long()[:, None], _bit(safe % WORD_BITS)[:, None])
    return torch.where((ids >= 0)[:, None], rows, 0)


class LabelStore(NamedTuple):
    """Frozen per-vertex label attributes.

    words  (N, W) int32 — the packed label bitset (the kernel operand)
    labels (N,)   int32 — the single label per vertex of `encode_labels`;
           None for multi-label stores, whose bitset is all there is.
    """

    words: torch.Tensor
    labels: torch.Tensor | None = None

    @property
    def n(self) -> int:
        return self.words.shape[0]

    @property
    def w(self) -> int:
        return self.words.shape[1]

    @property
    def capacity(self) -> int:
        """Largest representable label id + 1 (the frozen label space)."""
        return self.w * WORD_BITS


def encode_labels(labels, n_labels: int | None = None) -> LabelStore:
    """Freeze a (N,) int32 single-label-per-vertex array into a store.

    `n_labels` fixes the label space (and so W); it defaults to
    max(labels) + 1 but should be given when the corpus may not use every
    label.
    """
    labels = _tensor(labels, torch.int32)
    top = int(labels.max())
    if n_labels is None:
        n_labels = top + 1
    if n_labels < 1 or top >= n_labels:
        raise ValueError(f"label {top} outside the frozen space {n_labels}")
    return LabelStore(pack_ids(labels, n_labels), labels)


def encode_label_sets(member) -> LabelStore:
    """Freeze an (N, L) bool multi-label membership mask into a store."""
    return LabelStore(pack_bits(member), None)


def store_words(labels) -> torch.Tensor:
    """The (N, W) kernel operand of a LabelStore or raw packed words."""
    return labels.words if isinstance(labels, LabelStore) else _tensor(labels, torch.int32)


def query_words(filter, w: int) -> torch.Tensor:
    """A per-query predicate as the (Q, W) packed operand.

    Accepts (Q, W) packed int32 words (checked against the store's W), a
    (Q, L) bool allowed-label mask (L <= W * 32), or a (Q,) int32 allowed
    label id per query.
    """
    filter = _tensor(filter)
    if filter.ndim == 1:
        return pack_ids(filter, w * WORD_BITS)
    if filter.dtype == torch.bool:
        out = pack_bits(filter)
        if out.shape[1] > w:
            raise ValueError(f"predicate label space wider than the store: {out.shape[1]} > {w}")
        return torch.nn.functional.pad(out, (0, w - out.shape[1]))
    out = filter.to(torch.int32)
    if out.ndim != 2 or out.shape[1] != w:
        raise ValueError(f"packed predicate must be (Q, {w}), got {tuple(out.shape)}")
    return out


def _hit(vwords: torch.Tensor, fwords: torch.Tensor) -> torch.Tensor:
    """(Q, N) bool: any(vwords[n] & fwords[q] != 0), one word at a time, so
    the (Q, N, W) intermediate never exists."""
    hit = torch.zeros((fwords.shape[0], vwords.shape[0]), dtype=torch.bool, device=vwords.device)
    for i in range(vwords.shape[1]):
        hit |= (vwords[None, :, i] & fwords[:, i, None]) != 0
    return hit


def allowed_mask(ids, fwords, vwords) -> torch.Tensor:
    """allowed[q, j] of ids (Q, J) against query words (Q, W) and vertex
    words (N, W); ids < 0 are not allowed."""
    ids = _tensor(ids)
    lw = vwords[ids.clamp_min(0).long()]  # (Q, J, W)
    return (ids >= 0) & ((lw & fwords[:, None, :]) != 0).any(-1)


def predicate_fraction(ids, fwords, vwords) -> float:
    """Fraction of returned (non -1) ids that satisfy their query's
    predicate: the hard invariant of filtered search (must be 1.0)."""
    ids = _tensor(ids)
    n_ret = int((ids >= 0).sum())
    if n_ret == 0:
        return 1.0
    return int(allowed_mask(ids, fwords, vwords).sum()) / n_ret


def filtered_brute_force(x, queries, fwords, vwords, k: int, chunk: int = 1024) -> torch.Tensor:
    """Exact k nearest allowed rows per query, (Q, k) int32; slots beyond
    the allowed count hold -1 (filtered ground truth). `x` may be a
    VectorStore (ground truth in its dequantized space). Ties at equal
    distance come back in `torch.topk`'s order; recall compares sets."""
    outs = []
    for lo in range(0, queries.shape[0], chunk):
        d = ops.pairwise_sqdist(queries[lo : lo + chunk], x)  # (c, N)
        d = torch.where(_hit(vwords, fwords[lo : lo + chunk]), d, torch.inf)
        vals, idx = torch.topk(d, k, dim=-1, largest=False)
        outs.append(torch.where(torch.isfinite(vals), idx, -1).to(torch.int32))
    return torch.cat(outs)


def filtered_recall_at_k(found_ids, true_ids) -> float:
    """Recall against a -1-padded filtered ground truth: the denominator
    counts only real (>= 0) truth entries."""
    f = np.asarray(torch.as_tensor(found_ids).cpu())
    t = np.asarray(torch.as_tensor(true_ids).cpu())
    hits, total = 0, 0
    for row_f, row_t in zip(f, t):
        want = set(row_t[row_t >= 0].tolist())
        hits += len(set(row_f[row_f >= 0].tolist()) & want)
        total += len(want)
    return hits / max(total, 1)


def random_query_filters(
    generator: torch.Generator, q: int, n_labels: int, selectivity: float
) -> torch.Tensor:
    """(Q, W) predicates each allowing max(1, round(selectivity·n_labels))
    labels, drawn uniformly without replacement with `generator` (on its
    device). With labels uniform over vertices, vertex selectivity tracks
    label selectivity."""
    m = max(1, round(selectivity * n_labels))
    dev = generator.device
    perm = torch.rand((q, n_labels), generator=generator, device=dev).argsort(-1)
    member = torch.zeros((q, n_labels), dtype=torch.bool, device=dev)
    member.scatter_(1, perm[:, :m], True)
    return pack_bits(member)
