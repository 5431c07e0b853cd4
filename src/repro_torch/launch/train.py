"""Training entry point: --arch <id> [--steps N] with checkpoint / restart.

A port of the JAX package's `launch/train.py`. The reduced config by
default; `--full` for the real one (on a card). Wires together: config ->
model init -> train step -> deterministic data pipeline -> checkpoints ->
metrics log. Runs on the card unless `--device cpu` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --full --steps 200
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from repro_torch import convert
from repro_torch import device as _device
from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.configs import get_arch, reduced
from repro_torch.data import pipeline as PIPE
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 128, full: bool = False,
          ckpt_dir: str | None = None, save_every: int = 50, lr: float = 3e-4,
          log_every: int = 10, resume: bool = True, act_dtype=torch.float32,
          stop_at: int | None = None, device="cuda"):
    """Train `arch` from `init_params(seed=0)` (fp32) on `pipeline` batches
    with AdamW (`lr`, cosine over `steps`, warmup `steps // 10`). With
    `ckpt_dir`, saves every `save_every` steps (keeping the newest 3) and,
    with `resume`, starts from the newest checkpoint there. `stop_at`
    stops early as a preemption would: the schedule stays tied to `steps`.
    Returns (state, history): the metrics as floats at the first step and
    every `log_every`, with "step" and "wall_s"."""
    dev = _device.resolve(device)
    cfg = get_arch(arch)
    if not full:
        cfg = reduced(cfg)

    opt_cfg = O.AdamWConfig(lr=lr, total_steps=steps, warmup_steps=steps // 10)
    step_fn = TS.make_train_step(cfg, opt_cfg, act_dtype=act_dtype)

    params = T.init_params(cfg, seed=0, device=dev)
    state = TS.TrainState(params, O.init(dict(params.named_parameters())))

    start = 0
    if ckpt_dir and resume and (last := CKPT.latest_step(ckpt_dir)) is not None:
        tree = CKPT.restore(ckpt_dir, last, convert.train_state_to_jax(state, cfg))
        state = convert.train_state_from_jax(tree, cfg, device=dev)
        start = last
        print(f"resumed from step {last}")

    history = []
    t0 = time.time()
    # stop_at simulates preemption: the schedule stays tied to `steps`
    end = min(steps, stop_at) if stop_at is not None else steps
    for step in range(start, end):
        batch_data = PIPE.batch_for_step(cfg, step, batch, seq, device=dev)
        state, metrics = step_fn(state, batch_data)
        if (step + 1) % log_every == 0 or step == start:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step + 1
            m["wall_s"] = round(time.time() - t0, 1)
            history.append(m)
            print(f"step {step+1:5d}  loss {m['loss']:.4f}  "
                  f"ce {m['ce']:.4f}  gnorm {m['grad_norm']:.3f}", flush=True)
        if ckpt_dir and (step + 1) % save_every == 0:
            CKPT.save(ckpt_dir, step + 1, convert.train_state_to_jax(state, cfg))
            CKPT.prune_old(ckpt_dir)
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    _, history = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                       full=args.full, ckpt_dir=args.ckpt_dir, lr=args.lr, device=args.device)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(history, indent=2))


if __name__ == "__main__":
    main()
