"""Qwen2-1.5B [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936; QKV bias.  [arXiv:2407.10671]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    arch_type="dense",
    source="arXiv:2407.10671",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.reduced(
        name="qwen2-1.5b-smoke",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, max_seq_len=1024,
    )
