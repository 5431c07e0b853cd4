"""The uncompacted staging: `pools._rank` over a whole batch in one pass,
its inactive and self requests (dst set to -1) sorted along with the rest,
scattered into the (N, cap) buffers. `pools._stage` sorts only the active
requests and has to stage what this does, bitwise."""

import torch

from repro_torch.core import pools


def one_pass(dst, src, dist, n, cap, drop_self=True):
    """-> ids / dists (N, cap) of the batch staged without taking out its
    active requests."""
    if drop_self:
        dst = torch.where(dst == src, -1, dst)
    flat, src_s, dist_s = pools._rank(dst, src, dist, 0, n, n, cap)
    ids = torch.full((n * cap + 1,), -1, dtype=torch.int32, device=dst.device)
    dists = torch.full((n * cap + 1,), torch.inf, dtype=torch.float32, device=dst.device)
    ids.scatter_(0, flat, src_s.int())
    dists.scatter_(0, flat, dist_s.float())
    return ids[:-1].view(n, cap), dists[:-1].view(n, cap)


def active(dst, src, drop_self=True):
    """The requests a staging sorts: dst >= 0, and dst != src where
    self-inserts are dropped."""
    act = dst >= 0
    return act & (dst != src) if drop_self else act
