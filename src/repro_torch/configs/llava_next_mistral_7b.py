"""LLaVA-NeXT (Mistral-7B backbone) [vlm] — 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000; anyres tiling.  [hf:llava-hf/llava-v1.6-mistral-7b-hf]

The ViT/SigLIP vision tower + projector is a STUB: input_specs() provides
precomputed patch embeddings (B, n_patches, d_model).  anyres at 672x672
with 4 tiles + base image = 5 * 576 = 2880 patch tokens.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    arch_type="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
    frontend=FrontendConfig(kind="vision", n_tokens=2880, d_embed=4096),
)


def smoke_config() -> ModelConfig:
    return CONFIG.reduced(
        name="llava-next-mistral-7b-smoke",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, max_seq_len=1024,
        frontend=FrontendConfig(kind="vision", n_tokens=16, d_embed=256),
    )
