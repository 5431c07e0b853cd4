"""gemma3-1b [dense] — 5:1 local:global, single KV head, 128k context.

[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

GEMMA3_1B = register(ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_head=256,
    d_ff=6912,
    vocab=262_144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=512,
    qk_norm=True,
    post_norm=True,
    embed_scale=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; unverified",
))
