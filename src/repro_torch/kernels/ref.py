"""Plain oracles the port's tests hold its kernels to.

Counterpart of ``repro/kernels/ref.py`` (``block_copy_ref``, ``mha_ref``)
and of the sequential scan ``repro/models/gla.py::gla_scan_ref``, which
is kept here as a test oracle for ``kernels/gla_scan.py`` until the
model family that uses it is ported.
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


def gla_scan_ref(q, k, v, logw, u=None, mode: str = "mamba",
                 initial_state=None):
    """O(T) sequential gated-linear-attention scan, one token at a time.

    q, k: (B, H, T, N); v: (B, H, T, P); logw: (B, H, T, N) (broadcast a
    scalar decay over N).  ``mode="mamba"`` reads the state after the
    token's update; ``mode="rwkv"`` before it, plus the ``u`` (H, N) bonus
    on the token's own k v^T.  Returns y (B, H, T, P) in q's dtype and the
    final state (B, H, N, P) in fp32."""
    B, H, T, N = q.shape
    P = v.shape[-1]
    w = torch.exp(logw.float())
    q32, k32, v32 = q.float(), k.float(), v.float()
    S = (torch.zeros((B, H, N, P), dtype=torch.float32, device=q.device)
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(T):
        kv = k32[:, :, t, :, None] * v32[:, :, t, None, :]       # (B,H,N,P)
        if mode == "rwkv":
            read = S + (u[None, :, :, None] * kv if u is not None else kv)
            ys.append(torch.einsum("bhn,bhnp->bhp", q32[:, :, t], read))
            S = w[:, :, t, :, None] * S + kv
        else:
            S = w[:, :, t, :, None] * S + kv
            ys.append(torch.einsum("bhn,bhnp->bhp", q32[:, :, t], S))
    return torch.stack(ys, dim=2).to(q.dtype), S
