"""Model/architecture configuration dataclasses.

Every assigned architecture gets one module in ``repro_torch.configs`` exporting
``CONFIG`` (the full published config, used only via the dry-run) and
``smoke_config()`` (a reduced same-family variant for CPU smoke tests:
<=2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    n_shared_experts: int = 0
    # Layers that use MoE FFN.  "all" or "interleave:k" (every k-th layer).
    layer_pattern: str = "all"
    # Router capacity factor for the dense (einsum-dispatch) implementation.
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style SSD block config (used by zamba2 hybrid)."""
    state_dim: int = 64
    head_dim: int = 64
    n_heads: int = 0           # 0 -> derived as d_inner // head_dim
    expand: int = 2
    conv_kernel: int = 4
    chunk_size: int = 64


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 (Finch) time-mix config."""
    head_dim: int = 64
    decay_lora_rank: int = 64
    gate_lora_rank: int = 64
    chunk_size: int = 64


@dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend: input_specs() yields precomputed embeddings."""
    kind: str = "vision"       # "vision" | "audio"
    n_tokens: int = 2880       # patch/frame embedding count
    d_embed: int = 4096


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str             # dense | moe | ssm | hybrid | vlm | audio
    source: str                # provenance citation
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    max_seq_len: int = 131_072
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- layer pattern ------------------------------------------------
    # "uniform"                : all layers identical full attention
    # "local_global:R"         : R local (sliding window) : 1 global (gemma3)
    # "zamba2"                 : mamba2 backbone + shared attention block
    #                            inserted every `hybrid_attn_every` layers
    # "rwkv"                   : all layers RWKV6 time-mix + channel-mix
    layer_pattern: str = "uniform"
    sliding_window: Optional[int] = None
    hybrid_attn_every: int = 6       # zamba2: shared attn block frequency
    # --- sub-configs ----------------------------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    frontend: Optional[FrontendConfig] = None
    encoder_decoder: bool = False    # whisper
    n_encoder_layers: int = 0
    n_encoder_tokens: int = 1500     # whisper: 30 s of audio frames
    # Sub-quadratic decode support (gates the long_500k shape).
    supports_long_context_decode: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (approximate, embeddings included)."""
        from repro_torch.models.params import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.params import count_params_analytic
        return count_params_analytic(self, active_only=True)

    def reduced(self, **overrides) -> "ModelConfig":
        """Generic reduction helper used by smoke_config() implementations."""
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


INPUT_SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4_096, 256, "train"),
    InputShape("prefill_32k", 32_768, 32, "prefill"),
    InputShape("decode_32k", 32_768, 128, "decode"),
    InputShape("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}
