"""gemma3-27b [dense] — 5:1 local:global attention, 128k context, qk-norm.

[hf:google/gemma-3-1b-pt family; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

GEMMA3_27B = register(ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=21_504,
    vocab=262_144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    qk_norm=True,
    post_norm=True,
    embed_scale=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-27b-pt; unverified",
))
