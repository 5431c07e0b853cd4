"""GRNND: GPU-parallel Relative NN-Descent (paper Alg. 3/4).

As in the JAX package's `core/grnnd.py`:

  * disordered neighbor propagation (§3.3): every vertex samples
    `pairs_per_vertex` random slot pairs of its pool, applies the RNG
    criterion d(n_i, n_j) < max(d(v, n_i), d(v, n_j)) and redirects the
    farther endpoint into the closer endpoint's pool (`ops.rng_propagation_round`);
  * ascending / descending sorted rounds (§4.3 ablation, Fig. 7): the
    parallel form of the sequential UPDATE_NEIGHBORS (Alg. 2), each
    candidate checked against the neighbors already accepted in sorted
    order (`GRNNDConfig(order=...)`);
  * the double-buffered pool (§3.5): each round merges the survivors with
    the staged redirects into a new pool;
  * reverse edge sampling (§3.6): between outer iterations each vertex asks
    to be inserted into its top ρ·k neighbors' pools.

All pair evaluations of a round see the same pool snapshot; kills are
OR-combined at the end of the round. Every random number comes from a
`core.draws.Draws`. The dataset may be a `core.vecstore.VectorStore`: every
distance of the build is then taken on storage-precision rows, dequantized
in the kernels, with fp32 accumulation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch import trace
from repro_torch.core import pools as P
from repro_torch.core import vecstore as VS
from repro_torch.core.draws import Draws
from repro_torch.kernels import ops


class GRNNDConfig(NamedTuple):
    s: int = 16  # initial random neighbors per vertex
    r: int = 32  # pool capacity (R)
    t1: int = 3  # outer iterations (T1)
    t2: int = 4  # inner rounds (T2)
    rho: float = 0.6  # reverse-edge sampling ratio (ρ)
    pairs_per_vertex: int = 32  # sampled candidate pairs per round
    order: str = "disordered"  # "disordered" | "ascending" | "descending"
    incoming_cap: int | None = None  # staged insertions per vertex per round
    chunk_size: int | None = None  # vertex chunking of a round's draws and kernel calls

    @property
    def cap(self) -> int:
        return self.incoming_cap if self.incoming_cap is not None else self.r


def _sample_slot_pairs(draws, t1: int, t2: int, chunk: int | None, c: int, r: int, p: int, dev):
    """The shared pair sampling, drawn outside the kernel so every backend
    evaluates the identical pairs."""
    si, sj = draws.slot_pairs(t1, t2, chunk, c, r, p)
    return (
        si.to(device=dev, dtype=torch.int32).contiguous(),
        sj.to(device=dev, dtype=torch.int32).contiguous(),
    )


ORDERS = ("disordered", "ascending", "descending")

# rows per block of the sorted round: bounds its gathered (block, R, D) rows
# and (block, R, R) Gram (4.5 GB at R = 48, D = 128). The round draws
# nothing and its rows are independent, so blocks give the one-shot result.
SORTED_BLOCK = 1 << 17


def _pair_requests_chunk(x, ids_c, dists_c, si, sj):
    """The fused disordered round over a chunk as flat requests: (redirect
    `Requests` (C·P,), kill mask (C, R) bool). The dynamic index's
    localized rounds and the vertex-sharded build use this form."""
    dst, src, dij, killed = ops.rng_propagation_round(x, ids_c, dists_c, si, sj)
    redirect = P.Requests(dst=dst.reshape(-1), src=src.reshape(-1), dist=dij.reshape(-1))
    return redirect, killed


def _sorted_block(x, ids_c, dists_c, sign: float):
    """`_sorted_requests_chunk` over one block of rows: (dst, src, dist)
    (C, R) and kill (C, R)."""
    c, r = ids_c.shape
    order = torch.argsort(torch.where(ids_c >= 0, sign * dists_c, torch.inf), dim=-1, stable=True)
    ids_o = ids_c.gather(1, order)
    dv_o = dists_c.gather(1, order)
    valid_o = ids_o >= 0

    # pairwise distances among pool members, in sorted-slot space, on the
    # rows as stored (dequantized fp32, as the fused round reads them). The
    # Gram runs in full fp32, as B5's plain version does
    if x.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the sorted round's Gram needs torch.backends.cuda.matmul.allow_tf32 = False"
        )
    vecs = VS.take(x, ids_o.clamp_min(0).reshape(-1)).reshape(c, r, -1)
    xx = (vecs * vecs).sum(-1)
    dots = torch.bmm(vecs, vecs.transpose(1, 2))
    g = (xx[:, :, None] + xx[:, None, :] - 2.0 * dots).clamp_min(0.0)
    del vecs, dots

    slot = torch.arange(r, device=ids_c.device)
    accepted = torch.zeros((c, r), dtype=torch.bool, device=ids_c.device)
    red_dst = torch.empty((c, r), dtype=torch.int32, device=ids_c.device)
    red_d = torch.empty((c, r), dtype=torch.float32, device=ids_c.device)
    for i in range(r):  # the sequential scan over sorted slots
        g_i = g[:, i, :]  # (C, R)
        ok_i = valid_o[:, i]
        conflict = accepted & (g_i <= dv_o[:, i, None])
        any_conflict = conflict.any(-1)
        accepted[:, i] = ok_i & ~any_conflict
        # the first accepted conflictor in processing order
        j = torch.where(conflict, slot, r).amin(-1).clamp_max(r - 1)[:, None]
        red_dst[:, i] = torch.where(ok_i & any_conflict, ids_o.gather(1, j)[:, 0], -1)
        red_d[:, i] = g_i.gather(1, j)[:, 0]
    # kill = evaluated-and-rejected slots, back in the pool's slot order
    accepted_orig = torch.zeros_like(accepted).scatter_(1, order, accepted)
    return red_dst, ids_o, red_d, (ids_c >= 0) & ~accepted_orig


def _sorted_requests_chunk(x, ids_c, dists_c, cfg: GRNNDConfig, block: int | None = SORTED_BLOCK):
    """Alg. 2 per vertex on a snapshot of the pool, vectorized over rows.

    Candidates are taken in ascending (or descending) distance order; each
    is compared with every neighbor accepted before it, and a conflict
    (d(n, n') <= d(v, n)) rejects it and redirects it to the first accepted
    conflictor. Returns (redirect `Requests` (C·R,), kill mask (C, R)).
    Worked through in blocks of `block` rows (None: one shot).
    """
    sign = 1.0 if cfg.order == "ascending" else -1.0
    c = ids_c.shape[0]
    step = c if block is None else max(block, 1)
    parts = [
        _sorted_block(x, ids_c[lo : lo + step], dists_c[lo : lo + step], sign)
        for lo in range(0, c, step)
    ]
    dst, src, dist, killed = (torch.cat(p) for p in zip(*parts))
    redirect = P.Requests(dst=dst.reshape(-1), src=src.reshape(-1), dist=dist.reshape(-1))
    return redirect, killed


def _round_pair_matrices(x, pool: P.Pool, draws, cfg: GRNNDConfig, t1: int, t2: int):
    """Disordered round over all vertices: (dst, src, dij) (N, P) + kill (N, R).

    Chunked exactly when the JAX reference chunks (chunk_size divides N and
    is smaller than N), so that its per-chunk draws line up.
    """
    n, r = pool.ids.shape
    p = cfg.pairs_per_vertex
    chunk = cfg.chunk_size
    if chunk is None or n % chunk != 0 or chunk >= n:
        si, sj = _sample_slot_pairs(draws, t1, t2, None, n, r, p, x.device)
        return ops.rng_propagation_round(x, pool.ids, pool.dists, si, sj)
    outs = []
    for i in range(n // chunk):
        lo, hi = i * chunk, (i + 1) * chunk
        si, sj = _sample_slot_pairs(draws, t1, t2, i, chunk, r, p, x.device)
        outs.append(ops.rng_propagation_round(x, pool.ids[lo:hi], pool.dists[lo:hi], si, sj))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def update_round(x, pool: P.Pool, draws, cfg: GRNNDConfig, t1: int = 0, t2: int = 0) -> P.Pool:
    """One UPDATE_NEIGHBORS_PARALLEL round incl. buffer swap (Alg. 4).

    (t1, t2) names the round for `draws`. Survivors are per-vertex aligned
    and merge directly; only the cross-vertex redirects are staged: the
    disordered round's (N, P) matrices as they are, the sorted rounds'
    flat requests through `group_requests`.
    """
    n = pool.n
    with trace.span("grnnd.round"):
        if cfg.order == "disordered":
            with trace.span("grnnd.propagate"):
                dst, src, dij, killed = _round_pair_matrices(x, pool, draws, cfg, t1, t2)
            staged_i, staged_d = P.stage_request_matrix(dst, src, dij, n, cfg.cap)
            del dst, src, dij
        else:
            with trace.span("grnnd.propagate"):
                redirect, killed = _sorted_requests_chunk(x, pool.ids, pool.dists, cfg)
            staged_i, staged_d = P.group_requests(redirect, n, cfg.cap)
            del redirect
        # the requests are dead once staged, the kill mask once applied:
        # neither is held through the merge
        surv_ids = torch.where(killed, -1, pool.ids)
        surv_dists = torch.where(killed, torch.inf, pool.dists)
        del killed
        return P.merge_into(P.Pool(surv_ids, surv_dists), staged_i, staged_d)


def _reverse_requests(ids, dists, rho: float, row0: int = 0) -> P.Requests:
    """The reverse-edge requests of pool rows [row0, row0 + len(ids)): each
    vertex into its top ceil(ρ · degree) neighbors' pools, with ρ · degree
    taken in fp32 as the reference does (a float64 product rounds
    differently at, e.g., 0.6 · 5)."""
    n, r = ids.shape
    dev = ids.device
    rows = (row0 + torch.arange(n, dtype=torch.int32, device=dev))[:, None].expand(n, r)
    deg = (ids >= 0).sum(-1)[:, None].to(torch.float32)
    trace.count("grnnd.reverse")  # ρ is copied from the host: the stream synchronizes
    take = torch.ceil(torch.tensor(rho, dtype=torch.float32, device=dev) * deg).to(torch.int32)
    slot = torch.arange(r, dtype=torch.int32, device=dev)[None, :]
    sel = (slot < take) & (ids >= 0)
    return P.Requests(
        dst=torch.where(sel, ids, -1).reshape(-1),  # insert INTO the neighbor
        src=rows.reshape(-1),  # ... the owner vertex
        dist=dists.reshape(-1),  # d is symmetric
    )


def reverse_edge_round(pool: P.Pool, cfg: GRNNDConfig, rho: float | None = None) -> P.Pool:
    """Insert v into the pools of its top ρ·k neighbors (k = live degree).

    Pools are distance-sorted, so "top ρ·k" is a per-row prefix of
    ceil(ρ · degree) slots.
    """
    rho = cfg.rho if rho is None else rho
    with trace.span("grnnd.reverse"):
        return P.insert_requests(pool, _reverse_requests(pool.ids, pool.dists, rho), cap=cfg.cap)


def check_order(cfg: GRNNDConfig) -> None:
    if cfg.order not in ORDERS:
        raise ValueError(f"order must be one of {ORDERS}, got {cfg.order!r}")


def _build(x, cfg: GRNNDConfig, draws, device, stats: list | None) -> P.Pool:
    check_order(cfg)
    dev = _device.resolve(device)
    x = VS.to_device(x, dev)
    draws = draws if draws is not None else Draws(0, dev)
    with trace.span("grnnd.init"):
        pool = P.init_random(draws, x, cfg.s, cfg.r)
    for t1 in range(cfg.t1):
        for t2 in range(cfg.t2):
            new_pool = update_round(x, pool, draws, cfg, t1, t2)
            if stats is not None:
                stats.append(
                    {
                        "t1": t1,
                        "t2": t2,
                        "mean_degree": float(new_pool.degree().float().mean()),
                        "frac_changed": float((new_pool.ids != pool.ids).float().mean()),
                    }
                )
            pool = new_pool
        if t1 != cfg.t1 - 1:
            pool = reverse_edge_round(pool, cfg)
    return pool


def build_graph(x, cfg: GRNNDConfig, *, draws=None, device="cuda") -> P.Pool:
    """Construct the ANN graph: init -> T1 x (T2 rounds + reverse sampling).

    `x` is an (N, D) fp32 tensor or array, or a `VectorStore` (bf16 / int8
    rows, read through the kernels' fused dequant); it is moved to
    `device`, which defaults to "cuda" and raises without a card. `draws` (default:
    `Draws(0, device)`) supplies every random number of the build; the
    sorted orders (`cfg.order`) draw none past the init.
    """
    return _build(x, cfg, draws, device, None)


def build_graph_with_stats(x, cfg: GRNNDConfig, *, draws=None, device="cuda"):
    """`build_graph` that also returns per-round degree / change diagnostics."""
    stats: list = []
    return _build(x, cfg, draws, device, stats), stats
