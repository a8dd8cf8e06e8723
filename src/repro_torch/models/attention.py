"""GQA attention pieces the paged serving path uses.

Counterpart of ``repro/models/attention.py`` (``init_gqa``,
``_project_qkv``, ``_sdpa``).  Prefill attention is plain tensor code, as
in the reference, which computes it outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dense_init

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
