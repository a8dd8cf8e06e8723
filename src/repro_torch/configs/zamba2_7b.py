"""Zamba2-7B [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64; Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,          # 3584 / 32
    rope_theta=10_000.0,
    max_seq_len=4096,
    layer_pattern="zamba2",
    hybrid_attn_every=6,   # shared attention block every 6 mamba2 layers
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_kernel=4,
                  chunk_size=64),
    supports_long_context_decode=True,   # SSM state is O(1); attn KV windowless
)


def smoke_config() -> ModelConfig:
    return CONFIG.reduced(
        name="zamba2-7b-smoke",
        n_layers=3, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512, max_seq_len=1024, hybrid_attn_every=2,
        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, conv_kernel=4,
                      chunk_size=16),
    )
