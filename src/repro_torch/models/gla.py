"""Chunked gated linear attention: the recurrence engine of RWKV6
(per-channel data-dependent decay) and Mamba2/SSD (per-head scalar decay).

Counterpart of ``repro/models/gla.py``, in plain PyTorch and fp32.

Recurrence (per batch, head):
    S_t = diag(w_t) @ S_{t-1} + k_t v_t^T          S: (N, P)
    mamba read:  y_t = q_t @ S_t                    (current token decayed-in)
    rwkv  read:  y_t = q_t @ (S_{t-1} + diag(u) k_t v_t^T)

Both go through one chunked pass.  With L the inclusive cumsum of log w
along time, the contribution of j <= i is (q_i * exp(L_i - L_j)) . k_j:
  * mamba mode: j <= i, diagonal coefficient exp(0) = 1;
  * rwkv mode: strictly j < i with weight exp(L_{i-1} - L_j)
    = exp(L_i - L_j) * exp(-logw_i) (absorbed into q), plus the u-bonus
    diagonal term (q_i * u) . k_i.
Every exponent of a kept term is <= 0 within a chunk (log w <= 0).

Shapes: q, k: (B, H, T, N); v: (B, H, T, P); logw: (B, H, T, N), or
(B, H, T, 1) broadcast for a scalar decay.  ``gla_chunked`` returns y
(B, H, T, P) in q's dtype and the final state (B, H, N, P) in fp32.
Autograd differentiates every function here; the CUDA scan kernel
(``kernels/gla_scan.py``) has no backward and is called by
``models/mamba2.py`` only where no gradient is needed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint


def gla_scan_ref(q, k, v, logw, u=None, mode: str = "mamba",
                 initial_state=None):
    """O(T) sequential oracle, one token at a time.

    q, k: (B, H, T, N); v: (B, H, T, P); logw: (B, H, T, N) (broadcast a
    scalar decay over N).  ``mode="mamba"`` reads the state after the
    token's update; ``mode="rwkv"`` before it, plus the ``u`` (H, N) bonus
    on the token's own k v^T.  Returns y (B, H, T, P) in q's dtype and the
    final state (B, H, N, P) in fp32."""
    B, H, T, N = q.shape
    P = v.shape[-1]
    w = torch.exp(logw.float()).expand(B, H, T, N)
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


def _intra_per_channel(q_e, k_e, L_e):
    """A_ij = sum_n q_in k_jn exp(min(L_in - L_jn, 0)) of one chunk with a
    per-channel decay: the (B, H, C, C, N) decay factors materialised,
    exact and stable."""
    D = torch.exp(torch.clamp(
        L_e[..., :, None, :] - L_e[..., None, :, :], max=0.0))
    return torch.einsum("bhijn,bhjn->bhij", q_e[..., :, None, :] * D, k_e)


def gla_chunked(q, k, v, logw, u: Optional[torch.Tensor] = None,
                mode: str = "mamba", chunk: int = 64, initial_state=None,
                scalar_decay: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel gated linear attention: a loop over T / chunk
    chunks carrying the (B, H, N, P) state, batched products inside a
    chunk.  A per-channel decay materialises (B, H, C, C, N) decay
    factors per chunk (exact and stable), recomputed in the backward pass
    rather than kept; ``scalar_decay`` (mamba) takes the decay of channel
    0 and uses products only.  T is zero-padded to a multiple of
    ``chunk``: k = 0 adds nothing to the state and logw = 0 (decay 1)
    leaves it as it was, so the final state is exact and the padded rows
    are cut from y."""
    B, H, T, N = q.shape
    P = v.shape[-1]
    f32 = torch.float32
    logw = logw.to(f32).expand(B, H, T, N)
    T_orig = T
    pad = (-T) % chunk
    if pad:
        q, k, v, logw = (torch.nn.functional.pad(a, (0, 0, 0, pad))
                         for a in (q, k, v, logw))
        T = T + pad
    C, nc = chunk, T // chunk
    qc = q.to(f32).reshape(B, H, nc, C, N)
    kc = k.to(f32).reshape(B, H, nc, C, N)
    vc = v.to(f32).reshape(B, H, nc, C, P)
    lw = logw.reshape(B, H, nc, C, N)
    L = torch.cumsum(lw, dim=3)                       # inclusive

    if mode == "rwkv":
        q_eff = qc * torch.exp(-lw)                   # read S_{t-1}
        strict = True
    else:
        q_eff = qc
        strict = False
    i_idx = torch.arange(C, device=q.device)[:, None]
    j_idx = torch.arange(C, device=q.device)[None, :]
    mask = (j_idx < i_idx) if strict else (j_idx <= i_idx)
    zero = torch.zeros((), dtype=f32, device=q.device)

    S = (torch.zeros((B, H, N, P), dtype=f32, device=q.device)
         if initial_state is None else initial_state.to(f32))
    ys = []
    for c in range(nc):
        q_e, k_e, v_e = q_eff[:, :, c], kc[:, :, c], vc[:, :, c]
        L_e = L[:, :, c]
        # inter-chunk: the carried state read with decay exp(L_i)
        y_inter = (q_e * torch.exp(L_e)) @ S
        # intra-chunk.  The decay exponent is clamped at 0: for masked
        # (j > i) entries L_i - L_j > 0 can overflow exp, and the
        # overflowed values, masked in the forward pass, poison the
        # backward (0 * inf = NaN).  Kept (j <= i) entries have
        # exponents <= 0, so the clamp is exact.
        if scalar_decay:
            Ls = L_e[..., 0]                          # (B, H, C)
            A = q_e @ k_e.transpose(-1, -2)
            A = A * torch.exp(torch.clamp(
                Ls[..., :, None] - Ls[..., None, :], max=0.0))
        elif torch.is_grad_enabled():
            # recomputed in the backward pass: three (B, H, C, C, N) fp32
            # tensors a chunk would be kept otherwise (805 MB at
            # rwkv6-1.6b's B 8, 32 heads, C = N = 64; 39 GB over its 24
            # layers and two chunks of T 128)
            A = checkpoint(_intra_per_channel, q_e, k_e, L_e,
                           use_reentrant=False)
        else:
            A = _intra_per_channel(q_e, k_e, L_e)
        A = torch.where(mask, A, zero)
        ys.append(y_inter + A @ v_e)
        # S' = exp(L_C) * S + sum_j exp(L_C - L_j) k_j v_j^T
        L_tot = L_e[..., -1, :]                       # (B, H, N)
        k_scaled = k_e * torch.exp(L_tot[..., None, :] - L_e)
        S = torch.exp(L_tot)[..., :, None] * S \
            + k_scaled.transpose(-1, -2) @ v_e
    y = torch.stack(ys, dim=2).reshape(B, H, T, P)

    if mode == "rwkv" and u is not None:
        diag = torch.einsum("bhtn,hn,bhtn->bht", q.to(f32), u.to(f32),
                            k.to(f32))
        y = y + diag[..., None] * v.to(f32)
    return y[:, :, :T_orig].to(q.dtype), S


def gla_decode_step(q, k, v, logw, S, u=None, mode: str = "mamba"):
    """Single-token decode: q, k: (B, H, N); v: (B, H, P); logw: (B, H, N)
    or (B, H, 1); S: (B, H, N, P) fp32.  Returns (y (B, H, P) in q's
    dtype, S')."""
    f32 = torch.float32
    w = torch.exp(logw.to(f32).expand(q.shape))
    kv = k.to(f32)[..., :, None] * v.to(f32)[..., None, :]
    if mode == "rwkv":
        read = S + (u[None, :, :, None] * kv if u is not None else kv)
        y = torch.einsum("bhn,bhnp->bhp", q.to(f32), read)
        S = w[..., None] * S + kv
    else:
        S = w[..., None] * S + kv
        y = torch.einsum("bhn,bhnp->bhp", q.to(f32), S)
    return y.to(q.dtype), S
