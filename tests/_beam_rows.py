"""Beam-merge rows as the search makes them, and the expanded-flag match
that the search loop once computed after each merge: the oracle of the
merge's flag output (`topr_merge(..., flags=)`). Shared by the CPU tests of
the plain merge and the card tests of the kernel."""

from __future__ import annotations

import numpy as np
import torch


def beam_rows(b: int, ef: int, r: int, fill: float, seed: int):
    """(ids (B, ef + r) int32, dists fp32, expanded (B, ef) bool) of beam
    merges: ef candidates with unique ids, a share `fill` of them live and
    sorted by distance, the rest empty (-1, +inf), a few live ones at +inf
    distance; random expanded flags, set on some empty slots too. Then r
    fresh neighbors, a share `fill` live: a quarter repeat a candidate's id
    (expanded or not, and at any distance), the rest new ids, some repeated
    among themselves. Distances lie on a grid of 0.01, so ties occur within
    and across the two parts."""
    rng = np.random.default_rng(seed)
    w = ef + r
    uniq = np.argsort(rng.random((b, 4 * w)), axis=1).astype(np.int32)
    cand = uniq[:, :ef]
    live = rng.random((b, ef)) < fill
    cd = np.sort(np.round(rng.random((b, ef)), 2), axis=1).astype(np.float32)
    cd[live & (rng.random((b, ef)) < 0.05)] = np.inf
    ids = np.full((b, w), -1, np.int32)
    dists = np.full((b, w), np.inf, np.float32)
    ids[:, :ef] = np.where(live, cand, -1)
    dists[:, :ef] = np.where(live, cd, np.inf)
    rows = np.arange(b)[:, None]
    new = uniq[rows, ef + rng.integers(0, r, (b, r))]
    again = cand[rows, rng.integers(0, ef, (b, r))]
    fresh = np.where(rng.random((b, r)) < 0.25, again, new)
    fresh_live = rng.random((b, r)) < fill
    ids[:, ef:] = np.where(fresh_live, fresh, -1)
    fd = np.round(rng.random((b, r)), 2).astype(np.float32)
    dists[:, ef:] = np.where(fresh_live, fd, np.inf)
    expanded = rng.random((b, ef)) < 0.5
    return torch.from_numpy(ids), torch.from_numpy(dists), torch.from_numpy(expanded)


def match_flags(cand_ids: torch.Tensor, expanded: torch.Tensor, new_ids: torch.Tensor):
    """The merged beam's expanded flags by matching ids: an entry is
    expanded iff its id is that of an expanded candidate, and an empty slot
    counts as expanded (the -2 sentinel keeps empty slots from matching)."""
    exp_src = torch.where(expanded & (cand_ids >= 0), cand_ids, -2)
    return (new_ids[:, :, None] == exp_src[:, None, :]).any(-1) | (new_ids < 0)


def first_position_flags(ids: torch.Tensor, flags: torch.Tensor, out_ids: torch.Tensor):
    """The flags a merge output carries, found by search: a live output id
    came from the first position that holds it in its row (the merge keeps
    each id's first position), whose flag it takes (False past the F
    flagged positions); an empty slot takes True."""
    f = flags.shape[1]
    out = torch.ones(out_ids.shape, dtype=torch.bool)
    for i in range(ids.shape[0]):
        first = {}
        for pos, v in enumerate(ids[i].tolist()):
            first.setdefault(v, pos)
        for j, v in enumerate(out_ids[i].tolist()):
            if v >= 0:
                out[i, j] = bool(flags[i, first[v]]) if first[v] < f else False
    return out
