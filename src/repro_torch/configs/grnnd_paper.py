"""GRNND paper dataset configs: the paper's own benchmark shapes.

SIFT1M / DEEP1M / GIST1M, and reduced CPU-scale variants. A copy of the JAX
package's `configs/grnnd_paper.py` over this package's `GRNNDConfig`.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.grnnd import GRNNDConfig


@dataclasses.dataclass(frozen=True)
class ANNDatasetConfig:
    name: str
    n: int
    d: int
    n_queries: int
    k: int = 10
    build: GRNNDConfig = GRNNDConfig()


# full scale
SIFT1M = ANNDatasetConfig(
    "sift1m",
    n=1_000_000,
    d=128,
    n_queries=10_000,
    build=GRNNDConfig(s=24, r=48, t1=4, t2=6, rho=0.6, pairs_per_vertex=48, chunk_size=4096),
)
DEEP1M = ANNDatasetConfig(
    "deep1m",
    n=1_000_000,
    d=96,
    n_queries=10_000,
    build=GRNNDConfig(s=24, r=48, t1=3, t2=6, rho=0.6, pairs_per_vertex=48, chunk_size=4096),
)
GIST1M = ANNDatasetConfig(
    "gist1m",
    n=1_000_000,
    d=960,
    n_queries=1_000,
    build=GRNNDConfig(s=24, r=48, t1=5, t2=6, rho=0.6, pairs_per_vertex=48, chunk_size=2048),
)

# reduced scale (same structure)
SIFT_SMALL = ANNDatasetConfig(
    "sift-small",
    n=20_000,
    d=128,
    n_queries=500,
    build=GRNNDConfig(s=12, r=24, t1=3, t2=4, rho=0.6, pairs_per_vertex=24),
)
DEEP_SMALL = ANNDatasetConfig(
    "deep-small",
    n=20_000,
    d=96,
    n_queries=500,
    build=GRNNDConfig(s=12, r=24, t1=3, t2=4, rho=0.6, pairs_per_vertex=24),
)
GIST_SMALL = ANNDatasetConfig(
    "gist-small",
    n=8_000,
    d=960,
    n_queries=200,
    build=GRNNDConfig(s=12, r=24, t1=4, t2=4, rho=0.6, pairs_per_vertex=24),
)

# seconds-scale build: the launch-CLI end-to-end smoke tier
SIFT_DEMO = ANNDatasetConfig(
    "sift-demo",
    n=1_500,
    d=128,
    n_queries=100,
    build=GRNNDConfig(s=8, r=16, t1=3, t2=3, pairs_per_vertex=16),
)

DATASETS = {
    c.name: c for c in [SIFT1M, DEEP1M, GIST1M, SIFT_SMALL, DEEP_SMALL, GIST_SMALL, SIFT_DEMO]
}
