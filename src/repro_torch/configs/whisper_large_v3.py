"""Whisper-large-v3 [audio] — 32L d_model=1280 20H d_ff=5120 vocab=51866;
encoder-decoder; mel+conv frontend is a STUB (input_specs() provides
precomputed frame embeddings (B, 1500, 1280)).  [arXiv:2212.04356]"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    arch_type="audio",
    source="arXiv:2212.04356",
    n_layers=32,               # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    rope_theta=10_000.0,       # unused: whisper uses learned abs pos; we keep
    max_seq_len=448,           # decoder max target positions
    encoder_decoder=True,
    n_encoder_layers=32,
    n_encoder_tokens=1500,
    frontend=FrontendConfig(kind="audio", n_tokens=1500, d_embed=1280),
)


def smoke_config() -> ModelConfig:
    return CONFIG.reduced(
        name="whisper-large-v3-smoke",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512, max_seq_len=128,
        n_encoder_layers=2, n_encoder_tokens=32,
        frontend=FrontendConfig(kind="audio", n_tokens=32, d_embed=256),
    )
