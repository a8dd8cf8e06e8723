"""GQA attention: sequence mode (train / prefill) and decode against a
contiguous KV cache.

Counterpart of ``repro/models/attention.py``'s GQA half (``init_gqa``,
``_project_qkv``, ``_sdpa``, ``_sdpa_chunked``, ``causal_mask``,
``gqa_forward``, ``gqa_decode``).  Attention here is plain tensor code,
as in the reference, which computes it outside any Pallas kernel; the
paged decode path's kernel is ``kernels/paged_attention.py``.  The
reference's sharding constraints (``constrain_kv_seq``) are no-ops on one
device and are left out.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dense_init, apply_rope

NEG_INF = -1e30


def init_gqa(gen: torch.Generator, cfg: ModelConfig, device=None, lead=()):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": _dense_init(gen, (*lead, d, nq * hd), device=device),
        "wk": _dense_init(gen, (*lead, d, nkv * hd), device=device),
        "wv": _dense_init(gen, (*lead, d, nkv * hd), device=device),
        "wo": _dense_init(gen, (*lead, nq * hd, d), device=device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", nq * hd), ("bk", nkv * hd),
                            ("bv", nkv * hd)):
            p[name] = torch.zeros((*lead, width), dtype=torch.float32,
                                  device=device)
    return p


def _project_qkv(p, x, cfg: ModelConfig):
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(B, T, cfg.n_heads, hd)
    k = k.reshape(B, T, cfg.n_kv_heads, hd)
    v = v.reshape(B, T, cfg.n_kv_heads, hd)
    return q, k, v


def _sdpa(q, k, v, mask, scale):
    """q: (B,T,Hq,D) k,v: (B,S,Hkv,D); mask: broadcast (B,1,T,S) bool.

    Products of the storage dtype, accumulated in fp32 (the reference's
    ``preferred_element_type``); the probabilities are rounded to V's
    dtype before the P.V product, as in the reference."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B, T, Hkv, group, D)
    logits = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float()) * scale
    if mask is not None:
        m = mask[:, :, None] if mask.dim() == 4 else mask
        logits = torch.where(m, logits,
                             torch.full((), NEG_INF, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, T, Hq, D).to(q.dtype)


# Sequence lengths above this use the q-chunked path: peak attention
# memory (B, H, CHUNK_Q, S) instead of (B, H, T, S)
CHUNK_THRESHOLD = 4096
CHUNK_Q = 1024


def _sdpa_chunked(q, k, v, scale, window: Optional[int] = None,
                  chunk_q: int = CHUNK_Q):
    """Causal attention over query chunks of ``chunk_q``.  q: (B,T,Hq,D),
    k/v: (B,S,Hkv,D) with S == T (self-attention sequence mode).  Each
    chunk computes the masked full-S product, as the reference's scan
    body does; q is zero-padded to a multiple of ``chunk_q`` and the pad
    rows are cut off."""
    B, T, Hq, D = q.shape
    S = k.shape[1]
    pad = (-T) % chunk_q
    if pad:
        q = torch.cat([q, q.new_zeros((B, pad, Hq, D))], dim=1)
    kj = torch.arange(S, device=q.device)[None, :]
    outs = []
    for c0 in range(0, q.shape[1], chunk_q):
        qi = c0 + torch.arange(chunk_q, device=q.device)[:, None]
        m = kj <= qi                                       # (cq, S)
        if window is not None:
            m = m & (kj > qi - window)
        outs.append(_sdpa(q[:, c0:c0 + chunk_q], k, v, m[None, None],
                          scale))
    return torch.cat(outs, dim=1)[:, :T]


def causal_mask(T: int, S: int, window: Optional[int] = None,
                offset: int = 0, device=None) -> torch.Tensor:
    """(1, 1, T, S) bool; query i attends key j iff j <= i + offset and
    within ``window`` (if set)."""
    qi = torch.arange(T, device=device)[:, None] + offset
    kj = torch.arange(S, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (kj > qi - window)
    return m[None, None]


def gqa_forward(p, x, cfg: ModelConfig, positions,
                window: Optional[int] = None):
    """Sequence mode (train / prefill).  Returns (out, (k, v)), k and v
    (B, T, Hkv, D) after RoPE, for cache init."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    if T > CHUNK_THRESHOLD:
        out = _sdpa_chunked(q, k, v, scale, window=window)
    else:
        out = _sdpa(q, k, v, causal_mask(T, T, window, device=x.device),
                    scale)
    out = out.reshape(B, T, -1) @ p["wo"].to(x.dtype)
    return out, (k, v)


# int8 KV-cache quantisation: one fixed symmetric scale, as the reference
KV_QSCALE = 0.05


def quantize_kv(a):
    """bf16 K/V as the int8 cache stores them."""
    return torch.clamp(torch.round(a.float() / KV_QSCALE), -127,
                       127).to(torch.int8)


def gqa_decode(p, x, cfg: ModelConfig, cache_k, cache_v, pos,
               window: Optional[int] = None, ring: bool = False):
    """Decode one token.  x: (B, 1, d); cache_k/v: (B, S, Hkv, D); pos:
    an int or a 0-d integer tensor, the number of tokens already in the
    cache.

    With ``ring`` the cache is a ring buffer of S slots (a sliding
    window): the new token goes to slot pos % S and every slot is valid
    once pos >= S.  An int8 cache is quantised on write and dequantised
    on read (``KV_QSCALE``).  Returns (out, cache_k, cache_v): new caches,
    the inputs left unchanged, as the reference's
    ``dynamic_update_slice``."""
    B, S, Hkv, D = cache_k.shape
    q, k, v = _project_qkv(p, x, cfg)
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos.reshape(1, 1).expand(B, 1)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    quant = cache_k.dtype == torch.int8
    k_w, v_w = (quantize_kv(k), quantize_kv(v)) if quant else (k, v)
    # dynamic_update_slice clamps the start so that the row fits
    slot = pos % S if ring else torch.clamp(pos, max=S - 1)
    index = slot.reshape(1)
    cache_k = cache_k.index_copy(1, index, k_w.to(cache_k.dtype))
    cache_v = cache_v.index_copy(1, index, v_w.to(cache_v.dtype))
    if quant:
        k_r = cache_k.to(x.dtype) * KV_QSCALE
        v_r = cache_v.to(x.dtype) * KV_QSCALE
    else:
        k_r, v_r = cache_k, cache_v
    kj = torch.arange(S, device=x.device)
    if ring:
        valid = kj < torch.clamp(pos + 1, max=S)
    else:
        valid = kj <= pos
        if window is not None:
            valid = valid & (kj > pos - window)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    out = _sdpa(q, k_r, v_r, valid[None, None, None, :], scale)
    out = out.reshape(B, 1, -1) @ p["wo"].to(x.dtype)
    return out, cache_k, cache_v
