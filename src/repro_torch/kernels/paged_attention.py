"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/paged_attention.py``.  One query token per
sequence attends a paged KV pool through a block table, under GQA, with
fp32 accumulation.  ``pages_per_compute_block`` is the TPU kernel's page
tile: its table is padded with page 0 to a multiple of it, which only a
row with ``ctx == 0`` can see (such a row returns the uniform mean of V
over the padded table, as the TPU kernel's -1e30 mask gives).

On a CPU tensor the wrapper computes the plain PyTorch version; on a
CUDA tensor it launches ``csrc/paged_attention.cu`` (bf16, head_dim 128)
or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30


def _padded_pages(n_pages: int, pages_per_compute_block: int) -> int:
    ppcb = max(1, min(pages_per_compute_block, n_pages))
    return -(-n_pages // ppcb) * ppcb


def paged_attention_plain(q, k_pool, v_pool, block_tables, context_lens,
                          scale: float, pages_per_compute_block: int = 1):
    """Plain PyTorch version: gather the (padded) table's pages, mask
    positions >= ctx with -1e30 and take one fp32 softmax.

    q: (B, Hq, D); k_pool/v_pool: (nb, bs, Hkv, D); block_tables:
    (B, n_pages) int; context_lens: (B,) int.  Returns (B, Hq, D) in q's
    dtype."""
    B, Hq, D = q.shape
    _, bs, Hkv, _ = k_pool.shape
    n_pages = block_tables.shape[1]
    npp = _padded_pages(n_pages, pages_per_compute_block)
    bt = block_tables.long()
    if npp > n_pages:
        bt = torch.nn.functional.pad(bt, (0, npp - n_pages))
    S = npp * bs
    k = k_pool[bt].reshape(B, S, Hkv, D).float()
    v = v_pool[bt].reshape(B, S, Hkv, D).float()
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k) * scale
    valid = (torch.arange(S, device=q.device)[None, :]
             < context_lens.long()[:, None])                    # (B, S)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v)
    return out.reshape(B, Hq, D).to(q.dtype)


def _check_cuda_args(q, k_pool, v_pool, block_tables, context_lens):
    B, Hq, D = q.shape
    nb, bs, Hkv, Dk = k_pool.shape
    tensors = (q, k_pool, v_pool, block_tables, context_lens)
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all operands must be on one "
                         "CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: operands must be contiguous")
    if (q.dtype != torch.bfloat16 or k_pool.dtype != torch.bfloat16
            or v_pool.dtype != torch.bfloat16):
        raise TypeError("paged_attention: the CUDA kernel takes bf16 "
                        f"q/k/v, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables and context_lens "
                        "must be int32")
    if v_pool.shape != k_pool.shape or Dk != D:
        raise ValueError(f"paged_attention: pool shapes {tuple(k_pool.shape)}"
                         f"/{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if D != 128:
        raise ValueError(f"paged_attention: the CUDA kernel takes head_dim "
                         f"128, got {D}")
    if Hq % Hkv != 0 or Hq // Hkv > 8:
        raise ValueError(f"paged_attention: GQA group {Hq}/{Hkv} must be an "
                         "integer <= 8")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or context_lens.shape != (B,) or B > 65535:
        raise ValueError("paged_attention: block_tables must be (B, n_pages) "
                         "and context_lens (B,), B <= 65535")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_attention: q/k/v must be 16-byte aligned")


def paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                    scale: float, pages_per_compute_block: int = 1):
    """q: (B, Hq, D); k_pool/v_pool: (nb, bs, Hkv, D); block_tables:
    (B, n_pages) int32; context_lens: (B,) int32.  Returns (B, Hq, D).

    CPU tensors take ``paged_attention_plain``; CUDA tensors launch the
    kernel on the current stream (and count the launch in
    ``paged_attention.launches``)."""
    if not q.is_cuda:
        return paged_attention_plain(q, k_pool, v_pool, block_tables,
                                     context_lens, scale,
                                     pages_per_compute_block)
    _check_cuda_args(q, k_pool, v_pool, block_tables, context_lens)
    B, Hq, D = q.shape
    nb, bs, Hkv, _ = k_pool.shape
    n_pages = block_tables.shape[1]
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = build.library("paged_attention")
    code = lib.fs_paged_attention_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, D, bs, nb, n_pages,
        _padded_pages(n_pages, pages_per_compute_block), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(code, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
