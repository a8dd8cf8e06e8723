"""Tiled causal flash attention: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``repro/kernels/flash_attention.py``.  q, k, v are
(B, H, T|S, D) with GQA pre-expanded; the output is (B, H, T, D) in q's
dtype.  Scale D^-0.5, fp32 softmax.  The causal mask is the TPU kernel's:
key ``col`` is visible to query ``row`` when ``col <= row``, both counted
from index 0 (top-left aligned).  ``ref.mha_ref`` aligns its mask
bottom-right, so the two agree only when T == S.

``block_q`` and ``block_k`` keep the reference's contract (each capped at
T or S, which must be a multiple of it); the CUDA kernel's tiles are its
own, which changes nothing but the order of fp32 sums.  On a CPU tensor
the wrapper computes the plain version; on a CUDA tensor it launches
``csrc/flash_attention.cu`` (head_dim 64 or 128; bf16 on the tensor cores
with the softmax weights split into two bf16 terms, fp32 on the fp32
pipes) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, launches

NEG_INF = -1e30
HEAD_DIMS = (64, 128)


def _blocks(T: int, S: int, block_q: int, block_k: int):
    block_q, block_k = min(block_q, T), min(block_k, S)
    if block_q <= 0 or block_k <= 0 or T % block_q or S % block_k:
        raise ValueError(f"flash_attention: T {T} and S {S} must be "
                         f"multiples of block_q {block_q} and block_k "
                         f"{block_k}")
    return block_q, block_k


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          block_q: int = 128, block_k: int = 128):
    """Plain version: one fp32 softmax over q.k^T * D^-0.5 with masked
    scores at -1e30, normalised by max(l, 1e-30) as the TPU kernel's
    online softmax ends."""
    B, H, T, D = q.shape
    S = k.shape[2]
    _blocks(T, S, block_q, block_k)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * D ** -0.5
    if causal:
        rows = torch.arange(T, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhts,bhsd->bhtd", p, v.float())
    return (out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def _check_cuda_args(q, k, v):
    if any(not t.is_cuda or t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: q, k and v must be on one CUDA "
                         "device")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: the CUDA kernel takes q, k, v all "
                        f"fp32 or all bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    B, H, T, D = q.shape
    if k.shape != (B, H, k.shape[2], D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes head_dim "
                         f"{HEAD_DIMS}, got {D}")
    if B > 65535 or H > 65535:
        raise ValueError("flash_attention: B and H must be <= 65535")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """q: (B, H, T, D); k, v: (B, H, S, D) (GQA pre-expanded).  Returns
    (B, H, T, D) in q's dtype.

    CPU tensors take ``flash_attention_plain``; CUDA tensors launch the
    kernel on the current stream (and count it in
    ``flash_attention.launches``)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, T, D)")
    B, H, T, D = q.shape
    S = k.shape[2]
    _blocks(T, S, block_q, block_k)
    launches.refuse_shapes_only("flash_attention", q, k, v)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal,
                                     block_q=block_q, block_k=block_k)
    _check_cuda_args(q, k, v)
    out = torch.empty_like(q)
    if 0 in (B, H, T):
        return out
    lib = build.library("flash_attention")
    code = lib.fs_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, T,
        S, D, int(causal), int(q.dtype == torch.bfloat16), float(D ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(code, "flash_attention")
    launches.count(flash_attention)
    return out


flash_attention.launches = 0
