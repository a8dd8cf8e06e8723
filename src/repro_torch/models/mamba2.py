"""Mamba2 (SSD) block of the Zamba2 hybrid backbone.

Counterpart of ``repro/models/mamba2.py``.  Structure (arXiv:2405.21060
/ zamba2 arXiv:2411.15242):
  in_proj -> (z gate, x, B, C, dt); causal conv1d over [x, B, C];
  SSD recurrence per head with scalar decay  a_t = exp(A * softplus(dt + bias))
  (A < 0 learned per head), k = B_t (N), v = dt * x_t (P = head_dim),
  read q = C_t; y = y + D * x (skip), gated by silu(z), RMS-norm, out_proj.
State = (conv window, S) per layer.

Which scan the sequence forward runs (``ssd_scan``):
  * on CUDA tensors, with no gradient needed and a fresh (zero) state
    (the caller passes ``state=None``): the hand-written SSD scan,
    ``kernels/ops.py::gla_scan_scalar`` (``csrc/gla_scan.cu``), T padded
    with k = 0 and logw = 0 to a multiple of the chunk, which leaves the
    state exact;
  * where a gradient is needed, where a state is given, or on the CPU:
    ``models/gla.py::gla_chunked`` (scalar decay; under autograd where a
    gradient is needed), as the reference computes every scan through
    its jnp function.  The kernel has no backward and takes no initial
    state, so it is launched no time on these routes
    (``transformer.forward_seq`` starts every layer fresh, so its no-grad
    forward on CUDA takes the kernel).
A kernel that fails to build or launch raises (``kernels/gla_scan.py``);
nothing falls back to the plain scan.  Decode is the O(1) state update.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import ops
from repro_torch.models.gla import gla_chunked, gla_decode_step
from repro_torch.models.layers import _dense_init, rmsnorm, silu


class MambaState(NamedTuple):
    conv: torch.Tensor    # (B, K-1, conv_channels) trailing inputs
    S: torch.Tensor       # (B, H, N, P) fp32


def _dims(cfg: ModelConfig):
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = s.n_heads or d_inner // s.head_dim
    conv_channels = d_inner + 2 * s.state_dim * 1   # x + B + C (one group)
    return s, d_inner, n_heads, conv_channels


def init_mamba2_block(gen: torch.Generator, cfg: ModelConfig, device=None,
                      lead=()):
    """The reference's leaves, shapes and scales, each with the leading
    stacked axes ``lead``."""
    s, d_inner, H, conv_ch = _dims(cfg)
    d = cfg.d_model
    proj_out = 2 * d_inner + 2 * s.state_dim + H     # z, x, B, C, dt
    full = lambda shape, value: torch.full((*lead, *shape), value,
                                           dtype=torch.float32,
                                           device=device)
    return {
        "w_in": _dense_init(gen, (*lead, d, proj_out), device=device),
        "conv_w": _dense_init(gen, (*lead, s.conv_kernel, conv_ch),
                              scale=0.2, device=device),
        "conv_b": full((conv_ch,), 0.0),
        # A = -exp(A_log) < 0
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)
                           ).expand(*lead, H).clone(),
        "dt_bias": full((H,), 0.0),
        "D_skip": full((H,), 1.0),
        "norm_scale": full((d_inner,), 1.0),
        "w_out": _dense_init(gen, (*lead, d_inner, d), device=device),
    }


def block_params(cfg: ModelConfig) -> int:
    """Parameters of one block (``init_mamba2_block`` without ``lead``)."""
    s, d_inner, H, conv_ch = _dims(cfg)
    d = cfg.d_model
    proj_out = 2 * d_inner + 2 * s.state_dim + H
    return (d * proj_out + s.conv_kernel * conv_ch + conv_ch + 3 * H
            + d_inner + d_inner * d)


def _split_proj(proj, cfg: ModelConfig):
    s, d_inner, H, _ = _dims(cfg)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:d_inner + d_inner + 2 * s.state_dim]
    dt = proj[..., -H:]
    return z, xbc, dt


def _causal_conv(xbc, conv_w, conv_b, prev):
    """xbc: (B, T, C); prev: (B, K-1, C) trailing context.  Returns
    (silu(conv + bias), new trailing context), each op in xbc's dtype."""
    K = conv_w.shape[0]
    T = xbc.shape[1]
    x_ext = torch.cat([prev.to(xbc.dtype), xbc], dim=1)   # (B, T+K-1, C)
    out = torch.zeros_like(xbc)
    for i in range(K):
        out = out + x_ext[:, i:i + T] * conv_w[i].to(xbc.dtype)
    out = silu(out + conv_b.to(xbc.dtype))
    new_prev = x_ext[:, -(K - 1):] if K > 1 else prev
    return out, new_prev


def _softplus(x):
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``, no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssd_inputs(p, xbc, dt_raw, cfg: ModelConfig):
    """(q = C, k = B, v = dt * x, logw, xpart) for the scan: q, k, v
    (B, H, T, *) in xbc's dtype (q and k broadcast across heads, views),
    logw (B, H, T, 1) fp32 <= 0, xpart (B, T, H, P)."""
    s, d_inner, H, _ = _dims(cfg)
    B_, T = xbc.shape[0], xbc.shape[1]
    P, N = s.head_dim, s.state_dim
    xpart = xbc[..., :d_inner].reshape(B_, T, H, P)
    Bpart = xbc[..., d_inner:d_inner + N]                    # (B, T, N)
    Cpart = xbc[..., d_inner + N:]
    dt = _softplus(dt_raw.float() + p["dt_bias"].float())    # (B, T, H)
    A = -torch.exp(p["A_log"].float())                        # (H,)
    logw = (dt * A)[..., None]                                # (B, T, H, 1)
    v = (xpart.float() * dt[..., None]).to(xbc.dtype)
    q = Cpart[:, :, None, :].expand(B_, T, H, N)
    k = Bpart[:, :, None, :].expand(B_, T, H, N)
    tr = lambda a: a.transpose(1, 2)
    return tr(q), tr(k), tr(v), tr(logw), xpart


def kernel_chunk(chunk_size: int, T: int) -> int:
    """The scan kernel's chunk for T steps: the config's, or T rounded up
    to a multiple of 4 where that is shorter (the kernel takes chunks of
    multiples of 4; the reference's ``min(chunk_size, T)`` can be 1-3)."""
    return min(chunk_size, 4 * math.ceil(T / 4))


def ssd_scan_kernel(q, k, v, logw, chunk_size: int):
    """The SSD scan through ``ops.gla_scan_scalar`` from a zero state:
    q, k (B, H, T, N) (contiguous copies are made of broadcast views),
    v (B, H, T, P), logw (B, H, T, 1).  T is zero-padded (k = 0, logw =
    0) to a multiple of ``kernel_chunk``, and y cut back to T.  Returns
    (y (B, H, T, P) in q's dtype, S (B, H, N, P) fp32).  On a CPU tensor
    the wrapper computes its plain version."""
    T = q.shape[2]
    chunk = kernel_chunk(chunk_size, T)
    lw = logw[..., 0]
    pad = (-T) % chunk
    if pad:
        q, k, v = (torch.nn.functional.pad(a, (0, 0, 0, pad))
                   for a in (q, k, v))
        lw = torch.nn.functional.pad(lw, (0, pad))
    y, S = ops.gla_scan_scalar(q.contiguous(), k.contiguous(),
                               v.contiguous(), lw.float(), chunk=chunk)
    return y[:, :, :T], S


def ssd_scan(q, k, v, logw, cfg: ModelConfig,
             state: Optional[MambaState]):
    """The sequence scan by the module's rule (see the docstring):
    returns (y (B, H, T, P), S (B, H, N, P) fp32)."""
    need_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, logw))
    if q.is_cuda and not need_grad and state is None:
        return ssd_scan_kernel(q, k, v, logw, cfg.ssm.chunk_size)
    T = q.shape[2]
    return gla_chunked(q, k, v, logw, mode="mamba",
                       chunk=min(cfg.ssm.chunk_size, T),
                       initial_state=None if state is None else state.S,
                       scalar_decay=True)


def _finish(p, y, xpart, z, cfg: ModelConfig):
    """Skip, gate, norm and out_proj on the scan's y (B, T, H, P)."""
    s, d_inner, H, _ = _dims(cfg)
    B_, T = y.shape[:2]
    dt_ = xpart.dtype
    y = y + xpart * p["D_skip"].to(dt_)[None, None, :, None]
    y = y.reshape(B_, T, d_inner) * silu(z)
    y = rmsnorm({"scale": p["norm_scale"]}, y, cfg.norm_eps)
    return y @ p["w_out"].to(dt_)


def mamba2_block_forward(p, x, cfg: ModelConfig,
                         state: Optional[MambaState] = None
                         ) -> Tuple[torch.Tensor, MambaState]:
    """Sequence mode.  x: (B, T, d).  ``state=None`` starts from the zero
    state (``init_mamba_state``) and lets a no-grad CUDA forward run the
    scan kernel; from a given state the scan is ``gla_chunked``."""
    s, d_inner, H, conv_ch = _dims(cfg)
    B_, T, d = x.shape
    proj = x @ p["w_in"].to(x.dtype)
    z, xbc, dt_raw = _split_proj(proj, cfg)
    prev = (state.conv if state is not None else
            xbc.new_zeros((B_, s.conv_kernel - 1, conv_ch)))
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], prev)
    q, k, v, logw, xpart = _ssd_inputs(p, xbc, dt_raw, cfg)
    y, S = ssd_scan(q, k, v, logw, cfg, state)
    out = _finish(p, y.transpose(1, 2), xpart, z, cfg)
    return out, MambaState(conv=new_conv, S=S)


def mamba2_block_decode(p, x, cfg: ModelConfig, state: MambaState
                        ) -> Tuple[torch.Tensor, MambaState]:
    """Decode one token.  x: (B, 1, d)."""
    s, d_inner, H, _ = _dims(cfg)
    proj = x @ p["w_in"].to(x.dtype)
    z, xbc, dt_raw = _split_proj(proj, cfg)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], state.conv)
    q, k, v, logw, xpart = _ssd_inputs(p, xbc, dt_raw, cfg)
    y, S = gla_decode_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                           logw[:, :, 0], state.S, mode="mamba")
    out = _finish(p, y[:, None], xpart, z, cfg)              # (B, 1, H, P)
    return out, MambaState(conv=new_conv, S=S)


def init_mamba_state(cfg: ModelConfig, batch: int,
                     dtype=torch.bfloat16, device=None) -> MambaState:
    s, d_inner, H, conv_ch = _dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, s.conv_kernel - 1, conv_ch), dtype=dtype,
                         device=device),
        S=torch.zeros((batch, H, s.state_dim, s.head_dim),
                      dtype=torch.float32, device=device))
