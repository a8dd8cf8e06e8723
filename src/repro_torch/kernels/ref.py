"""Plain oracles the port's tests hold its kernels to.

Counterpart of ``repro/kernels/ref.py`` (``block_copy_ref``, ``mha_ref``).
The SSD scan's sequential oracle, ``gla_scan_ref``, lives with its model
family in ``models/gla.py``, as in the reference.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def block_copy_ref(src_pool, dst_pool, src_blocks, dst_blocks):
    """``dst_pool`` with blocks ``dst_blocks[i]`` replaced by
    ``src_pool[src_blocks[i]]`` (a new tensor; distinct, in-range
    indices).  src_pool: (nb_src, E); dst_pool: (nb_dst, E)."""
    out = dst_pool.clone()
    out[dst_blocks.long()] = src_pool[src_blocks.long()]
    return out


def mha_ref(q, k, v, causal: bool = True, scale: float | None = None):
    """Full attention oracle.  q: (B, T, H, D); k, v: (B, S, H, D) (same H:
    pre-expanded).  The causal mask is ``tril(ones(T, S), S - T)``: aligned
    bottom-right, so query t sees keys up to S - T + t."""
    B, T, H, D = q.shape
    S = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((T, S), dtype=torch.bool,
                          device=q.device).tril(S - T)
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs, v.float())
    return out.to(q.dtype)
