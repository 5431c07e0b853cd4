"""mamba2-130m [ssm] — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

MAMBA2_130M = register(ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50_280,
    layer_pattern=("ssm",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
))
