"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, qk-norm, GQA kv=4.

[hf:Qwen/Qwen3-235B-A22B (config family per Qwen3-30B-A3B); hf]
"""
from repro_torch.configs.base import ArchConfig, register

QWEN3_MOE_235B = register(ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=1536,                # kept for assignment fidelity (== d_expert)
    vocab=151_936,
    layer_pattern=("global",),
    n_experts=128,
    top_k=8,
    d_expert=1536,
    n_shared_experts=0,
    first_k_dense=0,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
