"""Architecture + shape registry, a copy of the JAX package's `configs/base.py`.

Every assigned architecture is an ArchConfig; every input-shape set is a
ShapeConfig. Configs are frozen dataclasses (hashable, comparable by value).
The port's models run the dense text families (`models/transformer.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

LayerKind = Literal["global", "local", "ssm", "shared_attn"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None        # defaults to d_model // n_heads
    # --- attention structure ---
    layer_pattern: tuple[str, ...] = ("global",)   # cycled to n_layers
    window: int = 0                  # sliding-window size for "local" layers
    attn_softcap: float = 0.0        # gemma2 attention logit soft-capping
    logit_softcap: float = 0.0       # gemma2 final logit soft-capping
    qk_norm: bool = False            # gemma3 / qwen3
    post_norm: bool = False          # gemma2/3 sandwich norms
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                # fine-grained expert hidden dim
    n_shared_experts: int = 0
    first_k_dense: int = 0           # deepseek: first k layers use dense FFN
    moe_capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4
    # --- modality ---
    modality: str = "text"           # text | audio_tokens | vision_text
    n_codebooks: int = 0             # musicgen
    vision_dim: int = 0              # internvl2 precomputed patch-embed dim
    vision_tokens: int = 0
    # --- misc ---
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    embed_scale: bool = False        # gemma: embeddings * sqrt(d_model)
    source: str = ""

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kinds(self) -> tuple[str, ...]:
        """The per-layer kind list, pattern cycled to n_layers."""
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: every layer is windowed, SSM, or the
        KV-bounded shared-attention block of a hybrid; pure full-attention
        stacks are not."""
        kinds = set(self.layer_kinds())
        if kinds <= {"ssm", "shared_attn", "local"}:
            return True
        # alternating local/global (gemma-style) and SWA: decode against a
        # seq-sharded KV is O(S) per token — eligible per DESIGN.md §5
        return "local" in kinds or "ssm" in kinds

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, v = self.d_model, self.vocab
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        hd = self.head_dim
        for kind in self.layer_kinds():
            if kind == "ssm":
                di, st, nh = self.d_inner, self.ssm_state, self.ssm_heads
                conv_ch = di + 2 * st
                total += d * (2 * di + 2 * st + nh)      # in_proj
                total += conv_ch * self.ssm_conv          # conv
                total += nh * 2                           # A, D
                total += di * d                           # out_proj
                total += 2 * d                            # norms
            elif kind == "shared_attn":
                continue  # counted once below
            else:
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                total += self.n_heads * hd * d            # o_proj
                if self.n_experts and self._is_moe_layer_static():
                    total += d * self.n_experts           # router
                    total += self.n_experts * 3 * d * self.d_expert
                    total += self.n_shared_experts * 3 * d * self.d_expert
                else:
                    total += 3 * d * self.d_ff
                total += 2 * d
        if "shared_attn" in self.layer_kinds():
            hd = self.head_dim
            total += d * hd * (self.n_heads + 2 * self.n_kv_heads)
            total += self.n_heads * hd * d
            total += 3 * d * self.d_ff + 2 * d
        if self.modality == "audio_tokens":
            total += (self.n_codebooks - 1) * v * d       # extra codebooks
            total += self.n_codebooks * v * d             # heads
        if self.modality == "vision_text":
            total += self.vision_dim * d + d * d          # projector
        return total

    def _is_moe_layer_static(self) -> bool:
        return self.n_experts > 0

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        n_moe_layers = max(self.n_layers - self.first_k_dense, 0)
        inactive = (self.n_experts - self.top_k) * 3 * d * self.d_expert
        return self.param_count() - n_moe_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str   # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    # import side-effect registration
    import repro_torch.configs  # noqa: F401
    return _REGISTRY[name]


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


def truncate_units(cfg: ArchConfig, k: int) -> ArchConfig:
    """Same arch with only k repeats of the pattern unit (plus any
    first-k-dense prefix and non-divisible tail).  Used by the dry-run cost
    probes: cost(full) = cost(k=1) + (units-1) * [cost(k=2) - cost(k=1)],
    because XLA's cost_analysis counts scanned bodies once per while loop.
    """
    body = cfg.n_layers - cfg.first_k_dense
    unit = min(len(cfg.layer_pattern), body)
    tail = body - (body // unit) * unit
    n_layers = cfg.first_k_dense + unit * k + tail
    return dataclasses.replace(cfg, n_layers=n_layers,
                               name=f"{cfg.name}-u{k}")


def n_pattern_units(cfg: ArchConfig) -> int:
    body = cfg.n_layers - cfg.first_k_dense
    unit = min(len(cfg.layer_pattern), body)
    return body // unit


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    base = dict(
        n_layers=max(2, len(cfg.layer_pattern)),
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_head=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        window=min(cfg.window, 32) if cfg.window else 0,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_expert=32 if cfg.d_expert else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        first_k_dense=min(cfg.first_k_dense, 1),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=16,
        vision_dim=32 if cfg.vision_dim else 0,
        vision_tokens=8 if cfg.vision_tokens else 0,
        name=cfg.name + "-smoke",
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
