"""OLMoE-1B-7B [moe] — 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8.  [arXiv:2409.02060]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    arch_type="moe",
    source="arXiv:2409.02060",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,             # per-expert FFN width
    vocab_size=50304,
    rope_theta=10_000.0,
    max_seq_len=4096,
    moe=MoEConfig(n_experts=64, top_k=8, d_expert_ff=1024,
                  n_shared_experts=0, layer_pattern="all"),
)


def smoke_config() -> ModelConfig:
    return CONFIG.reduced(
        name="olmoe-1b-7b-smoke",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=128, vocab_size=512, max_seq_len=1024,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert_ff=128,
                      n_shared_experts=0, layer_pattern="all",
                      capacity_factor=4.0),   # dropless at smoke scale
    )
