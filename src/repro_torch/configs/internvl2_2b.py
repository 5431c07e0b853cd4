"""internvl2-2b [vlm] — InternViT frontend (stub) + InternLM2-1.8B backbone.

Backbone only per the assignment: `input_specs()` provides precomputed patch
embeddings (B, vision_tokens, vision_dim); the framework projects them into
the LM sequence (first `vision_tokens` positions).
[arXiv:2404.16821; hf:OpenGVLab/InternVL2-2B]
"""
from repro_torch.configs.base import ArchConfig, register

INTERNVL2_2B = register(ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=92_553,
    layer_pattern=("global",),
    modality="vision_text",
    vision_dim=1024,
    vision_tokens=256,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="arXiv:2404.16821; hf",
))
