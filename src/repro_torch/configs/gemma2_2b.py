"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.

[arXiv:2408.00118; hf:google/gemma-2-2b]
"""
from repro_torch.configs.base import ArchConfig, register

GEMMA2_2B = register(ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=9216,
    vocab=256_000,
    layer_pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_norm=True,
    embed_scale=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2408.00118; hf",
))
