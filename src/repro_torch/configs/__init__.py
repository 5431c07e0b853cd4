"""Config registry: importing this package registers all ten architectures.

The dataset and build configurations of the GRNND paper live beside them in
`configs/grnnd_paper.py`.
"""
from repro_torch.configs.base import (
    ArchConfig, ShapeConfig, SHAPES, get_arch, list_archs, reduced)
from repro_torch.configs.gemma2_2b import GEMMA2_2B
from repro_torch.configs.h2o_danube_1_8b import H2O_DANUBE_1_8B
from repro_torch.configs.gemma3_27b import GEMMA3_27B
from repro_torch.configs.gemma3_1b import GEMMA3_1B
from repro_torch.configs.deepseek_moe_16b import DEEPSEEK_MOE_16B
from repro_torch.configs.qwen3_moe_235b_a22b import QWEN3_MOE_235B
from repro_torch.configs.musicgen_large import MUSICGEN_LARGE
from repro_torch.configs.mamba2_130m import MAMBA2_130M
from repro_torch.configs.zamba2_7b import ZAMBA2_7B
from repro_torch.configs.internvl2_2b import INTERNVL2_2B

ALL_ARCHS = [
    GEMMA2_2B, H2O_DANUBE_1_8B, GEMMA3_27B, GEMMA3_1B, DEEPSEEK_MOE_16B,
    QWEN3_MOE_235B, MUSICGEN_LARGE, MAMBA2_130M, ZAMBA2_7B, INTERNVL2_2B,
]

__all__ = [
    "ArchConfig", "ShapeConfig", "SHAPES", "get_arch", "list_archs",
    "reduced", "ALL_ARCHS",
]
