"""Parameter counting.

Counterpart of ``repro/models/params.py``: the reference counts the
leaves of ``init_params`` through ``jax.eval_shape``; the port counts
the same shapes analytically (``transformer.count_params``), for the
architectures it runs.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import count_params


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count.  ``active_only`` subtracts the routed
    experts a token does not activate, as the reference does: total -
    (E - top_k) / E * routed expert parameters (of every layer but a
    skip_first layer 0)."""
    total = count_params(cfg)
    if not active_only or cfg.moe is None:
        return total
    m = cfg.moe
    n_moe = cfg.n_layers - (1 if m.layer_pattern == "skip_first" else 0)
    routed = 3 * cfg.d_model * m.d_expert_ff * m.n_experts * n_moe
    return total - int(routed * (m.n_experts - m.top_k) / m.n_experts)
