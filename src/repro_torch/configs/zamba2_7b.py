"""zamba2-7b [hybrid] — Mamba2 backbone + periodically applied *shared*
attention block (one set of attention weights reused at every occurrence).

[arXiv:2411.15242; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

ZAMBA2_7B = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=112,
    d_ff=14_336,
    vocab=32_000,
    layer_pattern=("ssm", "ssm", "ssm", "ssm", "ssm", "shared_attn"),
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2411.15242; unverified",
))
