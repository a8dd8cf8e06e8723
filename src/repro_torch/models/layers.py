"""Shared model layers: norms, RoPE, SwiGLU MLP, embeddings.

Counterpart of ``repro/models/layers.py``.  Params are plain nested dicts
of tensors.  Compute dtype is bf16 (params stored fp32, cast at use; a
caller may pre-cast the matmul weights to bf16 once, which gives the same
values because the cast at use is a no-op on them).  Init functions take
an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

COMPUTE_DTYPE = torch.bfloat16


def _dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
                device=None):
    """N(0, 1/fan_in) fp32 weight; ``shape`` may carry a leading stacked
    layer axis, fan_in is then ``shape[-2]``."""
    fan_in = shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * scale


def init_rmsnorm(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a Python scalar base: no host tensor to copy to the device (a copy
    # from pageable memory would synchronise the stream)
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, D) or (..., T, D); positions: broadcastable to
    (..., T)."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)     # (D/2,)
    angles = positions[..., None].float() * freqs            # (..., T, D/2)
    if x.dim() == angles.dim() + 1:                          # heads axis
        angles = angles[..., None, :]                        # (..., T, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int, device=None,
                lead=()):
    return {
        "w_gate": _dense_init(gen, (*lead, d_model, d_ff), device=device),
        "w_up": _dense_init(gen, (*lead, d_model, d_ff), device=device),
        "w_down": _dense_init(gen, (*lead, d_ff, d_model), device=device),
    }


def silu(x):
    """x * sigmoid(x) written as the reference's ``jax.nn.silu`` lowers:
    x * (1 / (1 + exp(-x))), each op rounding to x's dtype.  In bf16 that
    agrees bit for bit with the reference, where ``F.silu`` (one rounding)
    differs from it by an ulp in ~40 % of the elements."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def swiglu(params, x):
    dt = x.dtype
    g = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    return (silu(g) * u) @ params["w_down"].to(dt)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   device=None):
    return {"table": torch.randn((vocab, d_model), generator=gen,
                                 dtype=torch.float32, device=device) * 0.02}


def embed(params, tokens):
    # gather first, then cast: the same values as casting the whole
    # table first (the reference's order) at a row's cost
    return params["table"][tokens].to(COMPUTE_DTYPE)


def unembed(params, x, table=None):
    """Project to vocab logits in fp32.  ``table`` overrides (tied
    embeddings)."""
    w = table if table is not None else params["table"]
    return x.float() @ w.float().T
