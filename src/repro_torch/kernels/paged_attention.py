"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/paged_attention.py``.  One query token per
sequence attends a paged KV pool through a block table, under GQA, with
fp32 accumulation.  ``pages_per_compute_block`` is the TPU kernel's page
tile: its table is padded with page 0 to a multiple of it, which only a
row with ``ctx <= 0`` (or ``ctx`` past the table) can see (a ``ctx <= 0``
row returns the uniform mean of V over the padded table, as the TPU
kernel's -1e30 mask gives).  Block ids follow the TPU index map: a
negative id counts from the end of the pool, then it is clamped.

On a CPU tensor the wrapper computes the plain PyTorch version; on a
CUDA tensor it launches ``csrc/paged_attention.cu`` (bf16, head_dim 128),
a split-KV kernel whose partition ``split_plan`` picks from shapes alone,
or raises.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build, launches
from repro_torch.kernels.block_copy import _block_index

NEG_INF = -1e30
STEP = 64               # tokens a CTA's four warps take per step
MAX_CHUNK_PAGES = 1024  # block-table entries a CTA stages
CTAS_PER_SM = 3         # the kernel's 64 KB ring allows three per SM
H100_SMS = 132


def _padded_pages(n_pages: int, pages_per_compute_block: int) -> int:
    ppcb = max(1, min(pages_per_compute_block, n_pages))
    return -(-n_pages // ppcb) * ppcb


def split_plan(B: int, Hkv: int, n_tokens: int, bs: int,
               num_sms: int = H100_SMS):
    """(n_splits, chunk): the split-KV partition of a padded table of
    ``n_tokens`` tokens (pages of ``bs``), from shapes alone.

    Split s walks tokens [s * chunk, min((s + 1) * chunk, n_tokens)).
    ``chunk`` is a multiple of STEP and of ``bs`` and at most
    MAX_CHUNK_PAGES pages; every split starts inside the table.  One
    split where the B * Hkv CTAs of a single split fill the card's
    CTAS_PER_SM * num_sms resident slots; else enough splits for twice
    those slots, since rows shorter than the table leave their late splits
    empty (those CTAs exit at once)."""
    unit = STEP * bs // math.gcd(STEP, bs)
    n_units = max(1, -(-n_tokens // unit))
    max_units = max(1, MAX_CHUNK_PAGES // (unit // bs))
    resident = CTAS_PER_SM * num_sms
    rows = B * Hkv
    want = 1 if rows >= resident else -(-2 * resident // rows)
    n_splits = min(n_units, max(want, -(-n_units // max_units)))
    units = -(-n_units // n_splits)
    return -(-n_units // units), units * unit


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def paged_attention_plain(q, k_pool, v_pool, block_tables, context_lens,
                          scale: float, pages_per_compute_block: int = 1,
                          plan_kv_heads: int = 0):
    """Plain PyTorch version: gather the (padded) table's pages, mask
    positions >= ctx with -1e30 and take one fp32 softmax (no split-KV
    partition, so ``plan_kv_heads`` changes nothing).

    q: (B, Hq, D); k_pool/v_pool: (nb, bs, Hkv, D); block_tables:
    (B, n_pages) int; context_lens: (B,) int.  Returns (B, Hq, D) in q's
    dtype."""
    B, Hq, D = q.shape
    nb, bs, Hkv, _ = k_pool.shape
    n_pages = block_tables.shape[1]
    npp = _padded_pages(n_pages, pages_per_compute_block)
    bt = block_tables.long()
    if npp > n_pages:
        bt = torch.nn.functional.pad(bt, (0, npp - n_pages))
    bt = _block_index(bt, nb)
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
                    scale: float, pages_per_compute_block: int = 1,
                    plan_kv_heads: int = 0):
    """q: (B, Hq, D); k_pool/v_pool: (nb, bs, Hkv, D); block_tables:
    (B, n_pages) int32; context_lens: (B,) int32.  Returns (B, Hq, D).

    ``plan_kv_heads``: the KV head count ``split_plan`` sizes the split-KV
    partition for (0: the pool's).  A tensor-parallel shard holds Hkv / M
    heads and passes the unsharded count, so each (row, head) CTA walks
    the splits, and sums in the order, it does in the one-device launch.
    The plain version has no partition and ignores it.

    CPU tensors take ``paged_attention_plain``; CUDA tensors launch the
    kernel on the current stream (and count the launch in
    ``paged_attention.launches`` and on ``k_pool``'s pool, or, inside a
    CUDA graph capture, in the capture's tally, which each replay adds:
    ``kernels.launches``)."""
    launches.refuse_shapes_only("paged_attention", q, k_pool, v_pool)
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
    npp = _padded_pages(n_pages, pages_per_compute_block)
    n_splits, chunk = split_plan(B, plan_kv_heads or Hkv, npp * bs, bs,
                                 _sm_count(q.device.index))
    # per split: fp32 m and l of each query head and its (D,) partial O
    ws = (torch.empty(B * Hq * n_splits * (D + 2), dtype=torch.float32,
                      device=q.device) if n_splits > 1 else None)
    lib = build.library("paged_attention")
    code = lib.fs_paged_attention_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), B, Hq, Hkv, D, bs, nb,
        n_pages, npp, n_splits, chunk, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(code, "paged_attention")
    launches.count(paged_attention, on=k_pool)
    return out


paged_attention.launches = 0
