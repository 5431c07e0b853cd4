"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf:h2oai/h2o-danube-1.8b-base]
"""
from repro_torch.configs.base import ArchConfig, register

H2O_DANUBE_1_8B = register(ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=80,
    d_ff=6912,
    vocab=32_000,
    layer_pattern=("local",),       # SWA on every layer (mistral-style)
    window=4096,
    rope_theta=10_000.0,
    tie_embeddings=False,
    source="arXiv:2401.16818; hf",
))
