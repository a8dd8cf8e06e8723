"""Parameter counting.

Counterpart of ``repro/models/params.py``: the reference counts the
leaves of ``init_params`` through ``jax.eval_shape``; the port counts
the same shapes analytically (``transformer.count_params``), for the
architectures it serves.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import count_params


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count.  ``active_only`` equals the total for the
    dense models the port serves (no routed experts)."""
    return count_params(cfg)
