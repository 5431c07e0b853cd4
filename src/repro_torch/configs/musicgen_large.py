"""musicgen-large [audio] — decoder-only over EnCodec tokens, 4 codebooks.

Backbone only per the assignment: the EnCodec frontend is a stub
(`input_specs()` provides the (B, S, n_codebooks) token grid directly).
[arXiv:2306.05284; hf:facebook/musicgen-large]
"""
from repro_torch.configs.base import ArchConfig, register

MUSICGEN_LARGE = register(ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=8192,
    vocab=2048,
    layer_pattern=("global",),
    modality="audio_tokens",
    n_codebooks=4,
    rope_theta=10_000.0,
    tie_embeddings=False,
    source="arXiv:2306.05284; hf",
))
