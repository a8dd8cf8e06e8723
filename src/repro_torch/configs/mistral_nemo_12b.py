"""Mistral-Nemo-12B [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k context.  [hf:mistralai/Mistral-Nemo-Base-2407]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    arch_type="dense",
    source="hf:mistralai/Mistral-Nemo-Base-2407",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,          # nemo uses head_dim=128 (not d_model/n_heads=160)
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
)


def smoke_config() -> ModelConfig:
    return CONFIG.reduced(
        name="mistral-nemo-12b-smoke",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, max_seq_len=1024,
    )
