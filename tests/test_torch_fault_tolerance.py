"""The port's fault-tolerance control plane
(`repro_torch.distributed.fault_tolerance`) on the CPU.

  * the reference's five `TestFaultTolerance` cases (failure detection,
    the elastic mesh shrinking, the straggler deadline skip and its floor,
    the supervisor's recovery), each one test parametrised over both
    packages;
  * `TrainingSupervisor` over the port's real train step (reduced
    gemma3-1b, fp32): checkpoints on disk every 5 steps through
    `checkpoint.save`, a host killed before step 7, the restart restoring
    step 5 through `checkpoint.restore` + `convert.train_state_from_jax`;
    after 10 steps every parameter, both moments and the step are bitwise
    those of 10 uninterrupted steps.
"""

import importlib

import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint import checkpoint as CK
from repro_torch.configs import get_arch, reduced
from repro_torch.data import pipeline as PIPE
from repro_torch.distributed.fault_tolerance import Coordinator, TrainingSupervisor
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS

PACKAGES = ("repro", "repro_torch")


@pytest.fixture(params=PACKAGES)
def ft(request):
    """One package's fault_tolerance module."""
    return importlib.import_module(f"{request.param}.distributed.fault_tolerance")


# ---------------------------------------------------------------------------
# the reference's cases, on both packages
# ---------------------------------------------------------------------------


def test_failure_detection(ft):
    clock = [0.0]
    c = ft.Coordinator(4, heartbeat_timeout=5.0, now=lambda: clock[0])
    clock[0] = 4.0
    for h in (0, 1, 2):
        c.heartbeat(h)
    clock[0] = 7.0
    dead = c.check_failures()
    assert dead == [3]
    assert c.alive_hosts() == [0, 1, 2]


def test_elastic_mesh_shrinks(ft):
    clock = [0.0]
    c = ft.Coordinator(8, heartbeat_timeout=1.0, now=lambda: clock[0])
    assert c.elastic_mesh_shape(chips_per_host=4, model_parallelism=4) == (8, 4)
    clock[0] = 2.0
    c.heartbeat(0)
    c.heartbeat(1)
    c.heartbeat(2)
    c.check_failures()
    # 3 hosts * 4 chips = 12 chips; TP=4 -> data=3 -> pow2 -> 2
    assert c.elastic_mesh_shape(4, 4) == (2, 4)


def test_straggler_deadline_skip(ft):
    pol = ft.StragglerPolicy(deadline_s=10.0, max_skip_frac=0.5)
    arrivals = {0: 1.0, 1: 2.0, 2: 50.0, 3: 3.0}
    keep, rescale = pol.select(arrivals)
    assert keep == [0, 1, 3]
    assert rescale == pytest.approx(4 / 3)


def test_straggler_min_keep_floor(ft):
    pol = ft.StragglerPolicy(deadline_s=1.0, max_skip_frac=0.25)
    arrivals = {0: 5.0, 1: 9.0, 2: 2.0, 3: 7.0}
    keep, rescale = pol.select(arrivals)  # all late: keep the fastest 3
    assert len(keep) == 3 and 2 in keep


def test_supervisor_recovers_from_failure(ft):
    """Kill a host mid-run; the supervisor resumes from the checkpoint."""
    clock = [0.0]
    coord = ft.Coordinator(4, heartbeat_timeout=5.0, now=lambda: clock[0])
    saved = {}

    def save_fn(state, step):
        saved[step] = state

    def restore_fn():
        step = max(saved)
        for h in coord.hosts.values():  # every host healthy again after the restart
            h.alive = True
            h.last_heartbeat = clock[0]
        return saved[step], step

    def step_fn(state, step):
        for h in coord.alive_hosts():
            coord.heartbeat(h)
        return state + 1

    def kill_host(c):
        c.hosts[2].last_heartbeat = -100.0

    sup = ft.TrainingSupervisor(coord, save_every=5, save_fn=save_fn, restore_fn=restore_fn)
    state, step = sup.run(0, step_fn, n_steps=20, events={12: kill_host})
    assert step == 20
    assert sup.restarts == 1
    # the rollback to the step-10 checkpoint makes the replayed work
    # invisible in the final state: exactly 20 effective increments
    assert state == 20


# ---------------------------------------------------------------------------
# the supervisor over the port's real train step and checkpoints
# ---------------------------------------------------------------------------

ARCH, BATCH, SEQ, STEPS, SAVE_EVERY, KILL_AT = "gemma3-1b", 2, 32, 10, 5, 7


def test_supervisor_restart_is_bitwise_uninterrupted_training(tmp_path):
    cfg = reduced(get_arch(ARCH))
    step_fn = TS.make_train_step(cfg, O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS),
                                 act_dtype=torch.float32)

    def fresh():
        params = T.init_params(cfg, seed=0, device="cpu")
        return TS.TrainState(params, O.init(dict(params.named_parameters())))

    def train(state, step):
        return step_fn(state, PIPE.batch_for_step(cfg, step, BATCH, SEQ, device="cpu"))[0]

    straight = fresh()
    for step in range(STEPS):
        straight = train(straight, step)

    clock = [0.0]
    coord = Coordinator(4, heartbeat_timeout=5.0, now=lambda: clock[0])
    like = convert.train_state_to_jax(fresh(), cfg)
    calls = []

    def step_and_beat(state, step):
        calls.append(step)
        for h in coord.alive_hosts():
            coord.heartbeat(h)
        return train(state, step)

    def save_fn(state, step):
        CK.save(tmp_path, step, convert.train_state_to_jax(state, cfg))

    def restore_fn():
        step = CK.latest_step(tmp_path)
        for h in coord.hosts.values():
            h.alive, h.last_heartbeat = True, clock[0]
        return convert.train_state_from_jax(CK.restore(tmp_path, step, like), cfg, device="cpu"), step

    def kill_host(c):
        c.hosts[2].last_heartbeat = -100.0

    sup = TrainingSupervisor(coord, save_every=SAVE_EVERY, save_fn=save_fn, restore_fn=restore_fn)
    state, step = sup.run(fresh(), step_and_beat, n_steps=STEPS, events={KILL_AT: kill_host})
    assert step == STEPS and sup.restarts == 1
    assert calls == list(range(KILL_AT)) + list(range(SAVE_EVERY, STEPS))
    assert CK.latest_step(tmp_path) == STEPS
    assert int(state.opt.step) == int(straight.opt.step) == STEPS
    for (name, x), (_, y) in zip(state.params.named_parameters(),
                                 straight.params.named_parameters()):
        assert torch.equal(x, y), name
    for name in straight.opt.mu:
        assert torch.equal(state.opt.mu[name], straight.opt.mu[name]), name
        assert torch.equal(state.opt.nu[name], straight.opt.nu[name]), name
