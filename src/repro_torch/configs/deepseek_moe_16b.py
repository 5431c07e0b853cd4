"""deepseek-moe-16b [moe] — fine-grained experts: 2 shared + 64 routed top-6.

First layer uses a dense FFN (d_ff = 10944); MoE layers use 1408-dim experts.
[arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base]
"""
from repro_torch.configs.base import ArchConfig, register

DEEPSEEK_MOE_16B = register(ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=10_944,              # dense first layer
    vocab=102_400,
    layer_pattern=("global",),
    n_experts=64,
    top_k=6,
    d_expert=1408,            # the assignment's d_ff=1408 (expert hidden)
    n_shared_experts=2,
    first_k_dense=1,
    rope_theta=10_000.0,
    tie_embeddings=False,
    source="arXiv:2401.06066; hf",
))
