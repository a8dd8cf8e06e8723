"""Gemma3-12B [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144; 5:1 local:global attention, 128k ctx.  [hf:google/gemma-3-1b-pt]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
    layer_pattern="local_global:5",
    sliding_window=1024,
    # Local layers keep a bounded window; global layers at decode are linear
    # per token -> long_500k decode runs (see DESIGN.md long_500k rules).
    supports_long_context_decode=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.reduced(
        name="gemma3-12b-smoke",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, max_seq_len=1024,
        sliding_window=64, layer_pattern="local_global:1",
    )
