"""Llama-3.2-3B [dense] — 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256.  [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    arch_type="dense",
    source="hf:meta-llama/Llama-3.2-1B",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    max_seq_len=131_072,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.reduced(
        name="llama3.2-3b-smoke",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, max_seq_len=1024,
    )
