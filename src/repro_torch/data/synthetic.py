"""Synthetic vector datasets and LM token streams drawn from a `torch.Generator`.

The presets model the paper's benchmark families, as in the JAX package's
`data/synthetic.py`:
  * "sift-like" — clustered, moderate dimension (SIFT1M: D=128)
  * "deep-like" — unit-norm embeddings (DEEP1M: D=96)
  * "gist-like" — high dimension (GIST1M: D=960)

Clustered Gaussian mixtures give the local-neighborhood structure that makes
graph ANN interesting. The data lands on the generator's device, so a
1M-row set is drawn on the card.
"""

from __future__ import annotations

import math

import torch


def vector_dataset(
    gen: torch.Generator,
    n: int,
    d: int,
    n_clusters: int = 64,
    cluster_std: float = 0.15,
    normalize: bool = False,
) -> torch.Tensor:
    """Clustered Gaussian mixture, roughly unit-scale coordinates, fp32."""
    dev = gen.device
    centers = torch.randn((n_clusters, d), generator=gen, device=dev)
    assign = torch.randint(0, n_clusters, (n,), generator=gen, device=dev)
    pts = centers[assign] + cluster_std * torch.randn((n, d), generator=gen, device=dev)
    if normalize:
        pts = pts / pts.norm(dim=-1, keepdim=True)
    return pts


def queries_from(gen: torch.Generator, x: torch.Tensor, q: int, noise: float = 0.05):
    """Queries near dataset points (the realistic ANN query regime)."""
    idx = torch.randint(0, x.shape[0], (q,), generator=gen, device=gen.device).to(x.device)
    noise_t = torch.randn((q, x.shape[1]), generator=gen, device=gen.device).to(x.device)
    return x[idx] + noise * noise_t


DATASET_PRESETS = {
    # name: (d, n_clusters, normalize) — reduced-scale stand-ins
    "sift-like": (128, 128, False),
    "deep-like": (96, 128, True),
    "gist-like": (960, 64, False),
    "tiny": (16, 16, False),
}


def make_preset(gen: torch.Generator, name: str, n: int) -> torch.Tensor:
    d, ncl, norm = DATASET_PRESETS[name]
    return vector_dataset(gen, n, d, n_clusters=ncl, normalize=norm)


def token_stream(gen: torch.Generator, batch: int, seq: int, vocab: int) -> torch.Tensor:
    """Zipf-ish synthetic (batch, seq) int32 token ids: rank
    floor(vocab^u) - 1 for u uniform in [1e-6, 1), as the JAX package draws
    them from its key."""
    u = torch.rand((batch, seq), generator=gen, device=gen.device) * (1.0 - 1e-6) + 1e-6
    ranks = torch.floor(torch.exp(u * math.log(float(vocab)))) - 1.0
    return ranks.clamp(0, vocab - 1).to(torch.int32)
