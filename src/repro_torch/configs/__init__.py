"""Architecture config registry of the port.

Holds every architecture of the reference's registry: the uniform GQA
decoders (dense, MoE, llava's language model), which the port trains and
serves, and the other families (the SSM and hybrid rwkv6-1.6b and
zamba2-7b, gemma3-12b's local/global pattern, deepseek-v2-236b's MLA with
its skip_first MoE, whisper-large-v3's encoder-decoder), which it trains
and runs through the contiguous-cache step functions but does not serve
in real mode (no paged path, as in the reference).  ``get_config(arch_id)``
returns the full published config; ``get_smoke_config(arch_id)`` the
reduced same-family variant the CPU tests use.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exports)
    INPUT_SHAPES,
    SHAPES_BY_NAME,
    FrontendConfig,
    InputShape,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    SSMConfig,
)

# arch id -> module name
_REGISTRY: Dict[str, str] = {
    "qwen2-1.5b": "repro_torch.configs.qwen2_1p5b",
    "llama3.2-3b": "repro_torch.configs.llama3p2_3b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1p6b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
}


def list_archs() -> List[str]:
    return list(_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return importlib.import_module(_REGISTRY[arch_id]).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return importlib.import_module(_REGISTRY[arch_id]).smoke_config()
