"""The merge's expanded-flag output on the plain path (`topr_merge(...,
flags=)`), which the beam loop reads in place of matching ids.

On beam rows (unique candidate ids first) the flags equal the id match the
search once computed after each merge; on any rows they follow each
output's surviving position; ids and dists are those of the merge without
flags. Runs on the CPU (the plain version); `tests/test_torch_cuda.py`
holds the kernel to it on the card.
"""

import numpy as np
import pytest
import torch
from _beam_rows import beam_rows, first_position_flags, match_flags

from repro_torch.kernels import ops, ref


@pytest.mark.parametrize("ef,r", [(16, 16), (48, 16), (64, 48), (128, 48), (400, 48)])
@pytest.mark.parametrize("fill", [0.1, 0.5, 1.0])
def test_plain_flags_are_the_id_match_on_beam_rows(ef, r, fill):
    ids, dists, expanded = beam_rows(64, ef, r, fill, seed=ef + r)
    new_ids, new_d, flags = ref.topr_merge_ref(ids, dists, ef, expanded)
    assert flags.dtype == torch.bool and flags.shape == (64, ef)
    assert torch.equal(flags, match_flags(ids[:, :ef], expanded, new_ids))
    plain_i, plain_d = ref.topr_merge_ref(ids, dists, ef)
    assert torch.equal(new_ids, plain_i) and torch.equal(new_d, plain_d)


@pytest.mark.parametrize(
    "b,w,r,f",
    [(40, 96, 48, 30), (30, 7, 12, 3), (10, 33, 1, 33), (20, 112, 64, 0), (8, 560, 512, 300)],
)
def test_plain_flags_follow_the_surviving_position(b, w, r, f):
    """Rows with repeats anywhere (the flagged part too), ties, -1 ids and
    +inf distances on live ids, r below and above W."""
    rng = np.random.default_rng(b + w + r)
    ids = torch.from_numpy(rng.integers(-1, max(2, w // 2), (b, w)).astype(np.int32))
    d = np.round(rng.random((b, w)), 1).astype(np.float32)
    d[rng.random((b, w)) < 0.1] = np.inf
    dists = torch.from_numpy(d)
    flags = torch.from_numpy(rng.random((b, f)) < 0.5)
    out_i, out_d, out_f = ops.topr_merge(ids, dists, r, flags=flags)
    assert torch.equal(out_f, first_position_flags(ids, flags, out_i))
    plain_i, plain_d = ops.topr_merge(ids, dists, r)
    assert torch.equal(out_i, plain_i) and torch.equal(out_d, plain_d)


def test_ref_backend_takes_the_flags_too():
    ids, dists, expanded = beam_rows(16, 64, 48, 0.5, seed=1)
    with ops.backend("ref"):
        got = ops.topr_merge(ids, dists, 64, flags=expanded)
    want = ref.topr_merge_ref(ids, dists, 64, expanded)
    assert len(got) == 3 and all(torch.equal(a, b) for a, b in zip(got, want))
