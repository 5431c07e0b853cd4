"""Fault tolerance, elasticity and straggler mitigation: the control plane.

A port of the JAX package's `distributed/fault_tolerance.py`, line for
line: it is plain Python. The control-plane logic (heartbeats, failure
detection, elastic re-meshing, deadline-based straggler skipping) is
hardware-independent and runs against a simulated host set; the data plane
is the real train step and `checkpoint/checkpoint.py`.

Recovery contract:
  1. the trainer checkpoints every K steps (atomic commit);
  2. the coordinator detects a missed heartbeat, removes the host, and
     picks the largest feasible mesh from the survivors (elastic re-mesh);
  3. the restart restores the latest committed step and training goes on
     bit-exact from the checkpoint.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    alive: bool = True


class Coordinator:
    """Failure detection and elastic mesh sizing over a (simulated) host set."""

    def __init__(self, n_hosts: int, heartbeat_timeout: float = 10.0,
                 now: Callable[[], float] = time.monotonic):
        self._now = now
        self.timeout = heartbeat_timeout
        t = now()
        self.hosts = {i: HostState(i, t) for i in range(n_hosts)}

    def heartbeat(self, host_id: int) -> None:
        h = self.hosts[host_id]
        h.last_heartbeat = self._now()
        h.alive = True

    def check_failures(self) -> list[int]:
        """Mark hosts that missed the heartbeat window; return the newly dead."""
        t = self._now()
        newly_dead = []
        for h in self.hosts.values():
            if h.alive and t - h.last_heartbeat > self.timeout:
                h.alive = False
                newly_dead.append(h.host_id)
        return newly_dead

    def alive_hosts(self) -> list[int]:
        return [h.host_id for h in self.hosts.values() if h.alive]

    def elastic_mesh_shape(self, chips_per_host: int,
                           model_parallelism: int) -> tuple[int, int]:
        """The largest (data, model) mesh on the surviving hosts.

        Keeps TP fixed (the architecture sets `model_parallelism`) and
        shrinks the data axis to the largest power of two that fits; the
        checkpoint restore handles the resharding.
        """
        chips = len(self.alive_hosts()) * chips_per_host
        data = max(chips // model_parallelism, 1)
        p = 1
        while p * 2 <= data:
            p *= 2
        return (p, model_parallelism)


@dataclasses.dataclass
class StragglerPolicy:
    """Deadline skip for slow hosts in the data pipeline.

    Hosts that miss the per-step deadline contribute no microbatch this
    step; the gradient mean is rescaled by the surviving fraction (the loss
    estimate stays unbiased, the throughput is protected). `max_skip_frac`
    bounds the quality impact.
    """
    deadline_s: float = 30.0
    max_skip_frac: float = 0.25

    def select(self, arrival_times: dict[int, float]) -> tuple[list[int], float]:
        """arrival_times: host -> seconds to produce its shard.

        Returns (hosts to include, gradient rescale factor).
        """
        n = len(arrival_times)
        on_time = [h for h, t in arrival_times.items() if t <= self.deadline_s]
        min_keep = int(n * (1.0 - self.max_skip_frac) + 0.999)
        if len(on_time) < min_keep:
            # too many stragglers: wait for the fastest min_keep instead
            ranked = sorted(arrival_times, key=arrival_times.get)
            on_time = ranked[:min_keep]
        rescale = n / max(len(on_time), 1)
        return sorted(on_time), rescale


class TrainingSupervisor:
    """A step function run with checkpoints and restarts.

    `run()` drives `step_fn(state, step) -> state` and the simulated host
    events (`events`: step -> fn(coordinator), each run once before that
    step); when the coordinator finds a dead host it counts a restart and
    resumes from `restore_fn() -> (state, step)`. `save_fn(state, step)` is
    called after every `save_every`-th step.
    """

    def __init__(self, coordinator: Coordinator, save_every: int, save_fn, restore_fn):
        self.coord = coordinator
        self.save_every = save_every
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.restarts = 0

    def run(self, state, step_fn, n_steps: int, start_step: int = 0,
            events: dict[int, Callable] | None = None):
        step = start_step
        while step < n_steps:
            if events and step in events:
                events.pop(step)(self.coord)
            dead = self.coord.check_failures()
            if dead:
                self.restarts += 1
                state, step = self.restore_fn()
                continue
            state = step_fn(state, step)
            step += 1
            if step % self.save_every == 0:
                self.save_fn(state, step)
        return state, step
