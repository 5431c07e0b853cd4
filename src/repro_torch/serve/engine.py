"""Batched LM serving engine: prefill + decode loop with KV / SSM caches.

A port of the JAX package's `serve/engine.py`: fixed-batch decoding with
greedy or temperature sampling, per-sequence stop handling, and the two
hooks that put retrieval in the loop (`retrieval/knn_lm.py`):

  * ``logit_hook(lm_logits, hidden) -> logits`` runs BEFORE sampling each
    step; ``hidden`` is the post-`final_norm` hidden state the logits were
    read from, the decode-time retrieval query;
  * ``token_hook(hidden, tokens)`` runs AFTER sampling each step with the
    same hidden state and the tokens it produced, the (key, value) pair a
    streaming kNN-LM datastore inserts during decode
    (`knn_lm.make_stream_hook`).

The engine runs eagerly under `torch.no_grad` (not inference mode: the hooks
may grow a datastore's buffers, which must stay writable after `generate`),
and decode writes the KV caches in place (the reference jits its steps and
donates the caches).
Greedy decoding is `argmax`; temperature sampling draws from the engine's
own `torch.Generator` (`seed=`), so its draws are not `jax.random`'s.
Audio models sample every codebook's head, (B, ncb) tokens a step, and take
no `eos_id`, as in the reference engine.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params: T.LMParams, *, s_max: int,
                 act_dtype=torch.bfloat16, logit_hook: Callable | None = None,
                 token_hook: Callable | None = None, seed: int = 0, device="cuda"):
        self.device = _device.resolve(device)
        if params.device != self.device:
            raise ValueError(f"the parameters are on {params.device}, not {self.device}")
        self.cfg = cfg
        self.params = params
        self.s_max = s_max
        self.act_dtype = act_dtype
        self.logit_hook = logit_hook
        self.token_hook = token_hook
        self.gen = torch.Generator(self.device).manual_seed(seed)

    def _sample(self, logits: torch.Tensor, temperature: float) -> torch.Tensor:
        """(..., V) logits -> (...) int32 tokens (the audio heads' (B, ncb))."""
        if temperature == 0.0:
            return logits.argmax(-1).to(torch.int32)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        tok = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=self.gen)
        return tok.reshape(probs.shape[:-1]).to(torch.int32)

    @torch.no_grad()
    def generate(self, batch, *, max_new_tokens: int, temperature: float = 0.0,
                 eos_id: int | None = None, return_hidden: bool = False) -> dict:
        """Prefill the prompt batch, then decode: {"tokens": (B, S)}, the
        audio frontend's (B, S, ncb), and the vision frontend's
        "patch_embeds" (B, P, vision_dim) beside its text tokens.

        Returns a dict with ``tokens`` (B, T) int32 ((B, T, ncb) for audio)
        and ``final_pos`` (B,);
        with ``return_hidden=True`` also ``hidden`` (B, T, D): per step, the
        post-`final_norm` state its token was sampled from (``hidden[:, t]``
        is the retrieval key whose next token is ``tokens[:, t]``, the pair
        a kNN-LM datastore stores).
        """
        cfg, dev = self.cfg, self.device
        batch = {name: _device.put(v, torch.int32 if name == "tokens" else None, dev)
                 for name, v in batch.items()}
        if cfg.modality == "audio_tokens":
            eos_id = None  # every codebook samples on, as in the reference engine
        logits, caches, plen, hidden = T.prefill(
            self.params, cfg, batch, s_max=self.s_max, act_dtype=self.act_dtype,
            return_hidden=True,
        )
        b = logits.shape[0]
        pos = torch.full((b,), plen, dtype=torch.int32, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        outs, hiddens = [], []
        for _ in range(max_new_tokens):
            if self.logit_hook is not None:
                logits = self.logit_hook(logits, hidden)
            tok = self._sample(logits, temperature)
            if eos_id is not None:
                done = done | (tok == eos_id)
                tok = torch.where(done, eos_id, tok)
            outs.append(tok)
            if return_hidden:
                hiddens.append(hidden)
            if self.token_hook is not None:
                self.token_hook(hidden, tok)
            logits, caches, hidden = T.decode_step(
                self.params, cfg, caches, tok, pos, act_dtype=self.act_dtype, return_hidden=True
            )
            pos = pos + 1
            if eos_id is not None and bool(done.all()):
                break
        out = {"tokens": torch.stack(outs, dim=1), "final_pos": pos}
        if return_hidden:
            out["hidden"] = torch.stack(hiddens, dim=1)
        return out
