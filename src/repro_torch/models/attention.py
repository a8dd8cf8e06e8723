"""Attention variants: GQA (full / sliding-window / cross) and DeepSeek
MLA, in sequence mode (train / prefill) and decode against a contiguous
cache.

Counterpart of ``repro/models/attention.py`` (``init_gqa``,
``_project_qkv``, ``_sdpa``, ``_sdpa_chunked``, ``causal_mask``,
``gqa_forward``, ``gqa_decode``; whisper's cross attention; MLA's
``MLACache``, ``init_mla``, ``mla_forward`` and the absorbed-weight
``mla_decode``).  Attention here is plain tensor code,
as in the reference, which computes it outside any Pallas kernel; the
paged decode path's kernel is ``kernels/paged_attention.py``.  K and V
pass through ``constrain_kv_seq`` where the reference's do: it returns
them unchanged unless the dry-run traces DTensors under an activation
context.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dense_init, apply_rope, recomputed
from repro_torch.models.sharding import constrain_kv_seq

NEG_INF = -1e30


def init_gqa(gen: torch.Generator, cfg: ModelConfig, device=None, lead=(),
             dtype=torch.float32):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {name: _dense_init(gen, (*lead, *shape), device=device, dtype=dtype)
         for name, shape in (("wq", (d, nq * hd)), ("wk", (d, nkv * hd)),
                             ("wv", (d, nkv * hd)), ("wo", (nq * hd, d)))}
    if cfg.qkv_bias:
        for name, width in (("bq", nq * hd), ("bk", nkv * hd),
                            ("bv", nkv * hd)):
            p[name] = torch.zeros((*lead, width), dtype=dtype,
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
    k = constrain_kv_seq(k)
    v = constrain_kv_seq(v)
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
    index = slot.reshape(1).long()     # the reference's position is int32
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


# ---------------------------------------------------------------------------
# Whisper's cross attention (no RoPE; K/V projected from the encoder)
# ---------------------------------------------------------------------------

def init_cross_attention(gen: torch.Generator, cfg: ModelConfig, device=None,
                         lead=(), dtype=torch.float32):
    return init_gqa(gen, cfg, device=device, lead=lead, dtype=dtype)


def cross_attention(p, x, enc_kv, cfg: ModelConfig, recompute: bool = False):
    """x: (B, T, d); enc_kv: (k, v) each (B, S_enc, Hkv, D); ``recompute``:
    the (B, H, T, S_enc) probabilities, as ``layers.recomputed``'s
    ``on``."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, T, cfg.n_heads, hd)
    k, v = enc_kv
    out = recomputed(recompute, _sdpa, q, k, v, None, 1.0 / math.sqrt(hd))
    return out.reshape(B, T, -1) @ p["wo"].to(dt)


def project_cross_kv(p, enc_out, cfg: ModelConfig):
    """The encoder's output (B, S_enc, d) as one decoder layer's cross
    K and V, each (B, S_enc, Hkv, D)."""
    B, S, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    dt = enc_out.dtype
    k = (enc_out @ p["wk"].to(dt)).reshape(B, S, cfg.n_kv_heads, hd)
    v = (enc_out @ p["wv"].to(dt)).reshape(B, S, cfg.n_kv_heads, hd)
    return k, v


# ---------------------------------------------------------------------------
# DeepSeek-V2 MLA (Multi-head Latent Attention)
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    latent: torch.Tensor   # (B, S, kv_lora_rank)
    k_rope: torch.Tensor   # (B, S, rope_head_dim)


def init_mla(gen: torch.Generator, cfg: ModelConfig, device=None, lead=(),
             dtype=torch.float32):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qd = m.nope_head_dim + m.rope_head_dim
    p = {name: _dense_init(gen, (*lead, *shape), device=device, dtype=dtype)
         for name, shape in (
             ("w_dq", (d, m.q_lora_rank)),
             ("w_uq", (m.q_lora_rank, H * qd)),
             ("w_dkv", (d, m.kv_lora_rank)),
             ("w_krope", (d, m.rope_head_dim)),
             ("w_uk", (m.kv_lora_rank, H * m.nope_head_dim)),
             ("w_uv", (m.kv_lora_rank, H * m.v_head_dim)),
             ("wo", (H * m.v_head_dim, d)))}
    p["q_norm"] = torch.ones((*lead, m.q_lora_rank), dtype=torch.float32,
                             device=device)
    p["kv_norm"] = torch.ones((*lead, m.kv_lora_rank), dtype=torch.float32,
                              device=device)
    return p


def _rms(x, scale, eps: float = 1e-5):
    """MLA's latent norms: RMSNorm in fp32 at a fixed eps of 1e-5 (not
    ``cfg.norm_eps``), as the reference."""
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
            * scale).to(x.dtype)


def _mla_queries(p, x, cfg: ModelConfig, positions):
    """(q_nope (B, T, H, dn), q_rope (B, T, H, dr) after RoPE)."""
    m = cfg.mla
    B, T, _ = x.shape
    dt = x.dtype
    cq = _rms(x @ p["w_dq"].to(dt), p["q_norm"])
    q = (cq @ p["w_uq"].to(dt)).reshape(B, T, cfg.n_heads,
                                        m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latents(p, x, cfg: ModelConfig, positions):
    """(latent (B, T, r) normed, k_rope (B, T, dr) after RoPE): what the
    cache holds per token."""
    dt = x.dtype
    latent = _rms(x @ p["w_dkv"].to(dt), p["kv_norm"])
    k_rope = apply_rope(x @ p["w_krope"].to(dt), positions, cfg.rope_theta)
    return latent, k_rope


def mla_forward(p, x, cfg: ModelConfig, positions):
    """Sequence mode: K and V expanded from the latent per head, the
    shared RoPE key broadcast to every head, V zero-padded to the q/k
    head dim so that the shared SDPA applies (``_sdpa_chunked`` above
    ``CHUNK_THRESHOLD``).  Returns (out, ``MLACache``)."""
    m = cfg.mla
    B, T, _ = x.shape
    H = cfg.n_heads
    dt = x.dtype
    q_nope, q_rope = _mla_queries(p, x, cfg, positions)
    latent, k_rope = _mla_latents(p, x, cfg, positions)
    k_nope = (latent @ p["w_uk"].to(dt)).reshape(B, T, H, m.nope_head_dim)
    v = (latent @ p["w_uv"].to(dt)).reshape(B, T, H, m.v_head_dim)
    k_nope = constrain_kv_seq(k_nope)
    v = constrain_kv_seq(v)
    qd = m.nope_head_dim + m.rope_head_dim
    scale = 1.0 / math.sqrt(qd)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, T, H, m.rope_head_dim)], dim=-1)
    v_pad = (torch.nn.functional.pad(v, (0, qd - m.v_head_dim))
             if m.v_head_dim < qd else v)
    if T > CHUNK_THRESHOLD:
        out = _sdpa_chunked(q_full, k_full, v_pad, scale)
    else:
        out = _sdpa(q_full, k_full, v_pad,
                    causal_mask(T, T, device=x.device), scale)
    out = out[..., :m.v_head_dim].reshape(B, T, -1) @ p["wo"].to(dt)
    return out, MLACache(latent=latent, k_rope=k_rope)


def mla_decode(p, x, cfg: ModelConfig, cache: MLACache, pos):
    """Absorbed-weight decode of one token, x (B, 1, d), against the
    latent cache: ``w_uk`` folded into the query (q_abs (B, H, r), a bf16
    product) and ``w_uv`` applied after the weighted sum, so the scores
    and the values read the (B, S, r) latents directly.  The three
    fp32-accumulated einsums take their bf16 operands upcast (exact) and
    keep the fp32 result, the reference's ``preferred_element_type``.
    Returns (out, new ``MLACache``), the input cache left unchanged."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    dt = x.dtype
    S = cache.latent.shape[1]
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos.reshape(1, 1).expand(B, 1)
    q_nope, q_rope = _mla_queries(p, x, cfg, positions)
    latent_t, k_rope_t = _mla_latents(p, x, cfg, positions)
    # dynamic_update_slice clamps the start so that the row fits
    index = torch.clamp(pos, max=S - 1).reshape(1).long()
    latent = cache.latent.index_copy(1, index, latent_t.to(
        cache.latent.dtype))
    k_rope = cache.k_rope.index_copy(1, index, k_rope_t.to(
        cache.k_rope.dtype))
    w_uk = p["w_uk"].to(dt).reshape(m.kv_lora_rank, H, m.nope_head_dim)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    logits = (torch.einsum("bhr,bsr->bhs", q_abs.float(), latent.float())
              + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                             k_rope.float())) * scale
    valid = (torch.arange(S, device=x.device) <= pos)[None, None, :]
    logits = torch.where(valid, logits,
                         torch.full((), NEG_INF, device=x.device))
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", probs.to(latent.dtype).float(),
                       latent.float())
    w_uv = p["w_uv"].to(dt).reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bhr,rhd->bhd", ctx.to(dt), w_uv)
    out = out.reshape(B, 1, -1) @ p["wo"].to(dt)
    return out, MLACache(latent=latent, k_rope=k_rope)
