"""Architecture config registry of the port.

Holds only the architectures the port can serve.  ``get_config(arch_id)``
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
