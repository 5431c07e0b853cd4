"""Data pipeline: deterministic, restart-safe synthetic batches.

A port of the JAX package's `data/pipeline.py`. Each step's batch is drawn
from its own `torch.Generator`, seeded from (seed, step) through
`step_generator` (the one seam: the reference folds the step into a
threefry key, which a `torch.Generator` cannot reproduce, so the port's
batches are its own; parity tests hand the reference's batches to the port
instead). So any step's batch can be drawn again without state, and a
resumed run sees the batches an uninterrupted one would.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.data import synthetic


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of step `step`'s batch, on `device`."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(2, np.uint64)
    return torch.Generator(device).manual_seed(int(state[0] >> np.uint64(1)))


def batch_for_step(cfg: ArchConfig, step: int, batch: int, seq: int, seed: int = 0,
                   device="cuda") -> dict:
    """Step `step`'s batch on `device`: {"tokens": (batch, seq)} Zipf token
    ids (`synthetic.token_stream`); for the audio frontend (batch, seq, ncb)
    uniform ids; for the vision frontend seq - vision_tokens text tokens and
    "patch_embeds" (batch, vision_tokens, vision_dim), 0.1 x a standard
    normal."""
    dev = _device.resolve(device)
    g = step_generator(seed, step, dev)
    if cfg.modality == "audio_tokens":
        return {"tokens": torch.randint(0, cfg.vocab, (batch, seq, cfg.n_codebooks), generator=g,
                                        device=dev, dtype=torch.int32)}
    if cfg.modality == "vision_text":
        return {
            "tokens": synthetic.token_stream(g, batch, seq - cfg.vision_tokens, cfg.vocab),
            "patch_embeds": 0.1 * torch.randn((batch, cfg.vision_tokens, cfg.vision_dim),
                                              generator=g, device=dev),
        }
    return {"tokens": synthetic.token_stream(g, batch, seq, cfg.vocab)}


def stream(cfg: ArchConfig, batch: int, seq: int, seed: int = 0, start_step: int = 0,
           device="cuda") -> Iterator[dict]:
    """`batch_for_step` for start_step, start_step + 1, ..."""
    step = start_step
    while True:
        yield batch_for_step(cfg, step, batch, seq, seed, device=device)
        step += 1
