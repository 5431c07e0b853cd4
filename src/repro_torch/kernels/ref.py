"""Plain PyTorch versions of the seven kernels of the build, search and
dynamic-index paths.

Each function computes what its counterpart in the JAX package's
`repro/kernels/ref.py` computes, on every rung of the precision ladder
(fp32, bf16 and int8 storage, with the per-dimension `scale`/`offset`
dequant) and with the tombstone mask and label predicate of
`search_expand_ref`. They are the port's own oracle: the CPU tests run
them, and on the card `chip_smoke.py` holds each hand-written CUDA kernel
against them on the same inputs. On the main path they run only for CPU
tensors or under `ops.backend("ref")`.

`dequant_rows` is the one dequant formula: the fp32 widen, then a multiply
and an add as two separate operations (never a fused multiply-add). The
CUDA kernels compute it as `__fadd_rn(__fmul_rn(q, scale), offset)`, so
kernel and plain version see bitwise-equal fp32 rows and differ only in
the order they sum a distance.

`pairwise_sqdist_ref` uses `torch.matmul`; on a card that is full fp32
only while `torch.backends.cuda.matmul.allow_tf32` is False (PyTorch's
default), which `chip_smoke.py` sets explicitly.

`rng_round_ref`, `gather_sqdist_ref` and `topr_merge_ref` work through
their rows in blocks: the results are row-independent, so blocking changes
no value, and it keeps the gathered (rows, P, D), (rows, D) and (rows, W, W)
intermediates a few hundred MB at N = 1M (a whole (M, D) gather for the
dynamic index's re-base would be 22 GB).
"""

from __future__ import annotations

import torch

__all__ = [
    "HASH_PROBES",
    "dequant_rows",
    "gather_sqdist_ref",
    "pairwise_sqdist_ref",
    "rowwise_sqdist_ref",
    "rng_round_ref",
    "search_expand_ref",
    "topr_merge_ref",
    "visited_insert_ref",
    "visited_probe_positions",
]

# Linear-probe window of the open-addressed visited table: shared by the
# oracle, the CUDA kernel and the table insert in core/search.py.
HASH_PROBES = 8

# elements per block of the blocked oracles (~256 MB of fp32)
_BLOCK_ELEMS = 1 << 26


def _row_blocks(rows: int, per_row: int):
    step = max(1, _BLOCK_ELEMS // max(per_row, 1))
    for lo in range(0, rows, step):
        yield lo, min(rows, lo + step)


def dequant_rows(data: torch.Tensor, scale=None, offset=None) -> torch.Tensor:
    """Stored rows -> fp32: the widen, then `* scale` and `+ offset` as two
    separate operations. scale/offset None = a float rung (fp32 or bf16
    storage), where the widen alone is exact."""
    x = data.float()
    if scale is not None:
        x = x * scale
        x = x + offset
    return x


def pairwise_sqdist_ref(
    x: torch.Tensor,
    y: torch.Tensor,
    x_scale=None,
    x_offset=None,
    y_scale=None,
    y_offset=None,
) -> torch.Tensor:
    """(M, D) x (N, D) -> (M, N) squared L2, as max(|x|^2 + |y|^2 - 2 x.y, 0).

    Either side may be stored rows with its own (D,) dequant."""
    x = dequant_rows(x, x_scale, x_offset)
    y = dequant_rows(y, y_scale, y_offset)
    xx = (x * x).sum(-1, keepdim=True)
    yy = (y * y).sum(-1)[None, :]
    return torch.clamp_min(xx + yy - 2.0 * (x @ y.T), 0.0)


def rowwise_sqdist_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, D) x (M, D) -> (M,) squared L2 of corresponding rows."""
    d = x.float() - y.float()
    return (d * d).sum(-1)


def gather_sqdist_ref(x, ni, nj, scale=None, offset=None) -> torch.Tensor:
    """(M,) d(x[ni[m]], x[nj[m]]) over stored rows, indices clamped to
    [0, N-1] (callers mask invalid entries themselves)."""
    n, d = x.shape
    if n == 0:
        raise ValueError("gather_sqdist: the dataset has no rows to read")
    m = ni.shape[0]
    out = torch.empty((m,), dtype=torch.float32, device=ni.device)
    for lo, hi in _row_blocks(m, d):
        xi = dequant_rows(x[ni[lo:hi].clamp(0, n - 1).long()], scale, offset)
        xj = dequant_rows(x[nj[lo:hi].clamp(0, n - 1).long()], scale, offset)
        diff = xi - xj
        out[lo:hi] = (diff * diff).sum(-1)
    return out


def rng_round_ref(x, ids, dists, si, sj, scale=None, offset=None):
    """One disordered RNG propagation round over a (C, R) pool chunk.

    For each sampled slot pair (si, sj) of a vertex: dij = |x[ni] - x[nj]|^2;
    the pair hits when both slots hold distinct ids and dij < max(dvi, dvj).
    Returns (dst (C,P) int32: the closer id or -1 on a miss, src (C,P)
    int32: the farther id, dij (C,P) fp32, kill (C,R) bool: OR of hits on
    the farther endpoint's slot). `x` holds stored rows, dequantized with
    the optional (D,) `scale`/`offset`.
    """
    c, r = ids.shape
    p = si.shape[1]
    si64, sj64 = si.long(), sj.long()
    ni = ids.gather(1, si64)
    nj = ids.gather(1, sj64)
    dvi = dists.gather(1, si64)
    dvj = dists.gather(1, sj64)
    valid = (ni >= 0) & (nj >= 0) & (ni != nj)

    dij = torch.empty((c, p), dtype=torch.float32, device=ids.device)
    for lo, hi in _row_blocks(c, p * x.shape[1]):
        xi = dequant_rows(x[ni[lo:hi].clamp_min(0).reshape(-1).long()], scale, offset)
        xj = dequant_rows(x[nj[lo:hi].clamp_min(0).reshape(-1).long()], scale, offset)
        diff = xi - xj
        dij[lo:hi] = (diff * diff).sum(-1).reshape(hi - lo, p)

    hit = valid & (dij < torch.maximum(dvi, dvj))
    i_is_far = dvi > dvj
    far = torch.where(i_is_far, ni, nj)
    close = torch.where(i_is_far, nj, ni)
    far_slot = torch.where(i_is_far, si64, sj64)
    dst = torch.where(hit, close, -1)
    kill = torch.zeros((c, r), dtype=torch.int32, device=ids.device)
    kill.scatter_reduce_(1, far_slot, hit.int(), reduce="amax")
    return dst.int(), far.int(), dij, kill.bool()


def visited_probe_positions(ids: torch.Tensor, h: int) -> torch.Tensor:
    """Probe positions (..., HASH_PROBES) of ids in an H-slot visited table:
    slot l of id v is (max(v, 0) % H + l) % H (identity-mod hash, linear
    probing; injective when H >= N)."""
    base = ids.clamp_min(0) % h
    offs = torch.arange(HASH_PROBES, dtype=base.dtype, device=base.device)
    return (base[..., None] + offs) % h


def visited_insert_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Insert (Q, R) ids into the (Q, H) open-addressed tables, in place.

    Sequential over the R columns, vectorized over queries, so no two
    inserts race for one empty slot. An id whose probe window holds neither
    itself nor an empty slot is dropped (a capacity miss). ids < 0 are
    skipped. Returns `table`.
    """
    h = table.shape[1]
    for rr in range(ids.shape[1]):
        v = ids[:, rr]
        pos = visited_probe_positions(v, h).long()  # (Q, PL)
        vals = table.gather(1, pos)
        found = (vals == v[:, None]).any(-1)
        empty = vals == -1
        ins = pos.gather(1, empty.to(torch.uint8).argmax(-1, keepdim=True))  # first empty
        do = (v >= 0) & ~found & empty.any(-1)
        cur = table.gather(1, ins)[:, 0]
        table.scatter_(1, ins, torch.where(do, v, cur)[:, None])
    return table


def search_expand_ref(
    x, queries, nbrs, table, valid=None, scale=None, offset=None, vwords=None, fwords=None
):
    """One beam-expansion step over (Q, R) neighbor ids.

    Returns (ids (Q,R) int32: -1 where nbrs < 0, dists (Q,R) fp32: the
    squared query->neighbor distance, +inf there, fresh (Q,R) bool: live
    and absent from the query's visited-table probe window). `x` holds
    stored rows, dequantized with the optional (D,) `scale`/`offset`;
    queries stay fp32. `valid` is the optional (N,) tombstone mask: a dead
    neighbor is exactly an empty slot (id -1, +inf, not fresh).

    `vwords` (N, W) / `fwords` (Q, W) int32 are the optional label
    predicate, both or neither: with them a fourth output `allowed` (Q, R)
    bool = live and `any(vwords[id] & fwords[q] != 0)`. Route-through: the
    predicate changes neither ids, dists nor fresh.
    """
    if (vwords is None) != (fwords is None):
        raise ValueError("search_expand_ref: give both vwords and fwords, or neither")
    q, r = nbrs.shape
    ok = nbrs >= 0
    if valid is not None:
        ok = ok & valid.bool()[nbrs.clamp_min(0).long()]
    nv = dequant_rows(x[nbrs.clamp_min(0).long()], scale, offset)  # (Q, R, D)
    diff = queries.float()[:, None, :] - nv
    d = torch.where(ok, (diff * diff).sum(-1), torch.inf)
    pos = visited_probe_positions(nbrs, table.shape[1])  # (Q, R, PL)
    vals = table.gather(1, pos.reshape(q, -1).long()).reshape(q, r, HASH_PROBES)
    found = (vals == nbrs[..., None]).any(-1)
    out = (torch.where(ok, nbrs, -1).int(), d, ok & ~found)
    if vwords is None:
        return out
    lw = vwords[nbrs.clamp_min(0).long()]  # (Q, R, W)
    return (*out, ok & ((lw & fwords[:, None, :]) != 0).any(-1))


def topr_merge_ref(ids: torch.Tensor, dists: torch.Tensor, r: int, flags=None):
    """Per row of (B, W) candidates: the r closest unique valid entries.

    An id of -1 counts as +inf; a slot whose id also sits at an earlier
    position is dropped; the survivors are taken in (dist, position) order
    (a stable sort); empty output slots are (-1, +inf).

    With `flags`, (B, F) bool flags of the first F <= W entries, the (B, r)
    output flags come third: a live slot takes the flag at the position it
    came from (False past F), an empty slot True.
    """
    ids = ids.int()
    dists = torch.where(ids < 0, torch.inf, dists.float())
    b, w = ids.shape
    if r > w:  # widen so the output is always (B, r)
        ids = torch.nn.functional.pad(ids, (0, r - w), value=-1)
        dists = torch.nn.functional.pad(dists, (0, r - w), value=torch.inf)
        w = r
    if flags is not None:
        fl = torch.zeros((b, w), dtype=torch.bool, device=ids.device)
        fl[:, : flags.shape[1]] = flags
        out_f = torch.empty((b, r), dtype=torch.bool, device=ids.device)
    earlier = torch.tril(torch.ones((w, w), dtype=torch.bool, device=ids.device), -1)
    out_i = torch.empty((b, r), dtype=torch.int32, device=ids.device)
    out_d = torch.empty((b, r), dtype=torch.float32, device=ids.device)
    for lo, hi in _row_blocks(b, w * w):
        bi, bd = ids[lo:hi], dists[lo:hi]
        dup = ((bi[:, :, None] == bi[:, None, :]) & earlier).any(-1)
        bd = torch.where(dup, torch.inf, bd)
        bi = torch.where(dup, -1, bi)
        order = torch.argsort(bd, dim=-1, stable=True)[:, :r]
        od = bd.gather(1, order)
        out_d[lo:hi] = od
        out_i[lo:hi] = torch.where(torch.isinf(od), -1, bi.gather(1, order))
        if flags is not None:
            out_f[lo:hi] = torch.isinf(od) | fl[lo:hi].gather(1, order)
    if flags is None:
        return out_i, out_d
    return out_i, out_d, out_f
