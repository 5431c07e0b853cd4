"""The launch CLIs' process group: `torchrun`'s, or one of one process."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def join(dev: torch.device) -> tuple[torch.device, bool]:
    """Join the default process group; returns (this rank's device,
    whether this call made the group, so the caller destroys it).

    An existing default group is used as it is. Under `torchrun` (RANK and
    WORLD_SIZE in the environment) the rank joins by the env:// rendezvous,
    on NCCL with a card (its card is LOCAL_RANK's unless `dev` names one)
    or gloo on the CPU. Outside `torchrun` the group is this process
    alone, through an in-memory store.
    """
    if dist.is_initialized():
        return dev, False
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    kw = {"device_id": dev} if cuda else {}
    backend = "nccl" if cuda else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    return dev, True


def launched() -> bool:
    """Whether this run has ranks: a default group, or `torchrun`'s
    environment."""
    return dist.is_initialized() or ("RANK" in os.environ and "WORLD_SIZE" in os.environ)


def world_size() -> int:
    """The ranks a CLI run has: the default group's, else `torchrun`'s
    WORLD_SIZE, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def first_ranks(k: int):
    """The default group's first k ranks as a group (the default group
    itself at k = world size); None on the ranks outside it. Every rank
    must call it."""
    if k == dist.get_world_size():
        return dist.group.WORLD
    group = dist.new_group(list(range(k)))
    return group if dist.get_rank() < k else None
