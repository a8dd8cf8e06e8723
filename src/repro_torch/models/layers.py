"""Shared model layers: norms, RoPE, SwiGLU and GELU MLPs, embeddings.

Counterpart of ``repro/models/layers.py``.  Params are plain nested dicts
of tensors.  Compute dtype is bf16 (params stored fp32, cast at use; a
caller may pre-cast the matmul weights to bf16 once, which gives the same
values because the cast at use is a no-op on them).  Init functions take
an explicit ``torch.Generator``; those of matmul weights take a storage
``dtype`` (each weight is drawn in fp32 and cast at once, so a bf16
init holds the values of ``serving_params`` of the fp32 one without the
fp32 tree beside it).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

COMPUTE_DTYPE = torch.bfloat16


def _dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
                device=None, dtype=torch.float32):
    """N(0, 1/fan_in) weight drawn in fp32 and stored in ``dtype``;
    ``shape`` may carry a leading stacked layer axis, fan_in is then
    ``shape[-2]``."""
    fan_in = shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device).mul_(scale)
    return w if dtype == torch.float32 else w.to(dtype)


def init_rmsnorm(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dtype)


def init_layernorm(d: int, device=None, lead=()):
    return {"scale": torch.ones((*lead, d), dtype=torch.float32,
                                device=device),
            "bias": torch.zeros((*lead, d), dtype=torch.float32,
                                device=device)}


def recomputed(on: bool, fn, *args):
    """``fn(*args)``; where ``on`` and a gradient is needed, through
    ``torch.utils.checkpoint``, so that only its inputs are kept and its
    intermediates are recomputed in the backward pass (the same numbers).
    whisper's layers turn it on where ``remat`` is off (with ``remat``
    the whole layer is recomputed): its LayerNorms (five fp32
    intermediates), GELUs (four) and attention probabilities would keep
    more than the card's 80 GB over the encoder's 12,000 frames at B 8."""
    if on and torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _layernorm(x, scale, bias, eps: float):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale + bias).to(dtype)


def layernorm(params, x, eps: float = 1e-5, recompute: bool = False):
    """LayerNorm in fp32 with the population variance (``jnp.var``);
    ``recompute`` as ``recomputed``'s ``on``."""
    return recomputed(recompute, _layernorm, x, params["scale"],
                      params["bias"], eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a Python scalar base: no host tensor to copy to the device (a copy
    # from pageable memory would synchronise the stream)
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                device=None):
    """(cos, sin) of the rotary angles at ``positions`` (..., T): each
    (..., T, head_dim / 2) fp32.  A forward computes them once and
    applies them to q and k of every layer with ``rope_apply``."""
    device = positions.device if device is None else device
    freqs = rope_freqs(head_dim, theta, device=device)       # (D/2,)
    angles = positions[..., None].float() * freqs            # (..., T, D/2)
    return torch.cos(angles), torch.sin(angles)


def rope_apply(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., T, H, D) or (..., T, D); cos, sin: ``rope_tables`` at x's
    positions, broadcastable to (..., T, D/2)."""
    if x.dim() == cos.dim() + 1:                             # heads axis
        cos, sin = cos[..., None, :], sin[..., None, :]      # (..., T, 1, D/2)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, D) or (..., T, D); positions: broadcastable to
    (..., T)."""
    return rope_apply(x, *rope_tables(positions, x.shape[-1], theta,
                                      device=x.device))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int, device=None,
                lead=(), dtype=torch.float32):
    return {
        "w_gate": _dense_init(gen, (*lead, d_model, d_ff), device=device,
                              dtype=dtype),
        "w_up": _dense_init(gen, (*lead, d_model, d_ff), device=device,
                            dtype=dtype),
        "w_down": _dense_init(gen, (*lead, d_ff, d_model), device=device,
                              dtype=dtype),
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


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                  device=None, lead=(), dtype=torch.float32):
    return {
        "w_in": _dense_init(gen, (*lead, d_model, d_ff), device=device,
                            dtype=dtype),
        "b_in": torch.zeros((*lead, d_ff), dtype=dtype, device=device),
        "w_out": _dense_init(gen, (*lead, d_ff, d_model), device=device,
                             dtype=dtype),
        "b_out": torch.zeros((*lead, d_model), dtype=dtype, device=device),
    }


# GELU's tanh form as the reference's ``jax.nn.gelu`` (approximate=True)
# writes it; its constants are rounded to the activations' dtype
GELU_C = math.sqrt(2 / math.pi)
GELU_CUBIC = 0.044715


@functools.lru_cache(maxsize=None)
def _constant(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: a tensor times
    it computes in fp32 and rounds once, the product of two ``dtype``
    values that the reference rounds (exact in fp32 for bf16), with no
    host tensor to copy to the device."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def gelu(x):
    """0.5 x (1 + tanh(c (x + 0.044715 x^3))), c = sqrt(2 / pi), each op
    rounding to x's dtype with its constants in that dtype, as
    ``jax.nn.gelu`` computes it (x^3 as (x * x) * x).  ``F.gelu``
    defaults to the erf form, and its tanh form rounds once."""
    dt = x.dtype
    inner = x + _constant(GELU_CUBIC, dt) * (x * x * x)
    cdf = 0.5 * (1.0 + torch.tanh(_constant(GELU_C, dt) * inner))
    return x * cdf


def gelu_mlp(params, x, recompute: bool = False):
    """``recompute``: the GELU's intermediates, as ``recomputed``'s ``on``."""
    dt = x.dtype
    h = recomputed(recompute, gelu,
                   x @ params["w_in"].to(dt) + params["b_in"].to(dt))
    return h @ params["w_out"].to(dt) + params["b_out"].to(dt)


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
