"""RWKV6-1.6B "Finch" [ssm] — 24L d_model=2048 attention-free, d_ff=7168
vocab=65536; data-dependent decay.  [arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    source="arXiv:2404.05892",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # 2048 / head_dim 64
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    head_dim=64,
    layer_pattern="rwkv",
    rwkv=RWKVConfig(head_dim=64, decay_lora_rank=64, gate_lora_rank=64,
                    chunk_size=64),
    max_seq_len=1_048_576,            # recurrent: unbounded in principle
    supports_long_context_decode=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.reduced(
        name="rwkv6-1.6b-smoke",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512, max_seq_len=1024,
        rwkv=RWKVConfig(head_dim=64, decay_lora_rank=16, gate_lora_rank=16,
                        chunk_size=16),
    )
