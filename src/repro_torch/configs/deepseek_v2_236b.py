"""DeepSeek-V2-236B [moe] — 60L d_model=5120 128H d_ff=1536 vocab=102400;
MLA kv_lora=512; MoE 2 shared + 160 routed top-6.  [arXiv:2405.04434]"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    source="arXiv:2405.04434",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,          # MLA: latent cache shared across heads
    d_ff=1536,               # routed expert FFN width (dense first layer 12288)
    vocab_size=102400,
    rope_theta=10_000.0,
    max_seq_len=131_072,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert_ff=1536,
                  n_shared_experts=2, layer_pattern="skip_first"),
)


def smoke_config() -> ModelConfig:
    return CONFIG.reduced(
        name="deepseek-v2-236b-smoke",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, max_seq_len=1024,
        mla=MLAConfig(kv_lora_rank=64, q_lora_rank=96,
                      rope_head_dim=16, nope_head_dim=32, v_head_dim=32),
        moe=MoEConfig(n_experts=4, top_k=2, d_expert_ff=128,
                      n_shared_experts=1, layer_pattern="skip_first",
                      capacity_factor=4.0),   # dropless at smoke scale
    )
