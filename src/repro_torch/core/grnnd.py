"""GRNND: GPU-parallel Relative NN-Descent (paper Alg. 3/4), disordered order.

As in the JAX package's `core/grnnd.py`:

  * disordered neighbor propagation (§3.3): every vertex samples
    `pairs_per_vertex` random slot pairs of its pool, applies the RNG
    criterion d(n_i, n_j) < max(d(v, n_i), d(v, n_j)) and redirects the
    farther endpoint into the closer endpoint's pool (`ops.rng_propagation_round`);
  * the double-buffered pool (§3.5): each round merges the survivors with
    the staged redirects into a new pool;
  * reverse edge sampling (§3.6): between outer iterations each vertex asks
    to be inserted into its top ρ·k neighbors' pools.

All pair evaluations of a round see the same pool snapshot; kills are
OR-combined at the end of the round. Every random number comes from a
`core.draws.Draws`. The dataset may be a `core.vecstore.VectorStore`: every
distance of the build is then taken on storage-precision rows, dequantized
in the kernels, with fp32 accumulation. The sorted-order ablation
(ascending / descending) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import device as _device
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


def _pair_requests_chunk(x, ids_c, dists_c, si, sj):
    """Request-tuple adapter over the fused round (the dynamic index's
    localized rounds): (redirect Requests, kill mask (C, R) bool)."""
    dst, src, dij, killed = ops.rng_propagation_round(x, ids_c, dists_c, si, sj)
    redirect = P.Requests(dst=dst.reshape(-1), src=src.reshape(-1), dist=dij.reshape(-1))
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
    and merge directly; only the cross-vertex redirects are staged.
    """
    n = pool.n
    dst, src, dij, killed = _round_pair_matrices(x, pool, draws, cfg, t1, t2)
    staged_i, staged_d = P.stage_request_matrix(dst, src, dij, n, cfg.cap)
    surv_ids = torch.where(killed, -1, pool.ids)
    surv_dists = torch.where(killed, torch.inf, pool.dists)
    return P.merge_into(P.Pool(surv_ids, surv_dists), staged_i, staged_d)


def reverse_edge_round(pool: P.Pool, cfg: GRNNDConfig, rho: float | None = None) -> P.Pool:
    """Insert v into the pools of its top ρ·k neighbors (k = live degree).

    Pools are distance-sorted, so "top ρ·k" is a per-row prefix of
    ceil(ρ · degree) slots, with ρ · degree taken in fp32 as the reference
    does (a float64 product rounds differently at, e.g., 0.6 · 5).
    """
    rho = cfg.rho if rho is None else rho
    n, r = pool.ids.shape
    dev = pool.ids.device
    rows = torch.arange(n, dtype=torch.int32, device=dev)[:, None].expand(n, r)
    deg = pool.degree()[:, None].to(torch.float32)
    take = torch.ceil(torch.tensor(rho, dtype=torch.float32, device=dev) * deg).to(torch.int32)
    slot = torch.arange(r, dtype=torch.int32, device=dev)[None, :]
    sel = (slot < take) & (pool.ids >= 0)
    req = P.Requests(
        dst=torch.where(sel, pool.ids, -1).reshape(-1),  # insert INTO the neighbor
        src=rows.reshape(-1),  # ... the owner vertex
        dist=pool.dists.reshape(-1),  # d is symmetric
    )
    return P.insert_requests(pool, req, cap=cfg.cap)


def _build(x, cfg: GRNNDConfig, draws, device, stats: list | None) -> P.Pool:
    dev = _device.resolve(device)
    x = VS.to_device(x, dev)
    draws = draws if draws is not None else Draws(0, dev)
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
    `Draws(0, device)`) supplies every random number of the build.
    """
    return _build(x, cfg, draws, device, None)


def build_graph_with_stats(x, cfg: GRNNDConfig, *, draws=None, device="cuda"):
    """`build_graph` that also returns per-round degree / change diagnostics."""
    stats: list = []
    return _build(x, cfg, draws, device, stats), stats
