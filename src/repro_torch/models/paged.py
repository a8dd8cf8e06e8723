"""Paged-KV decode step and chunked prefill for the serving engine.

Counterpart of ``repro/models/paged.py`` (single-device branch).  Runs a
uniform dense GQA transformer one token per sequence against the paged
pool through block tables, with the hand-written paged-attention kernel.
The engine pads the batch to a bucket; padding rows point their block
table at a reserved trash block and are masked by the caller.

Where the reference DONATES the pool, the context lengths, the last
tokens or the prefill carries, the port writes in place on the tensors it
was given and returns them, so the call sites keep the reference's
"rebind to the result" form.  The per-layer KV write is a plain in-place
index write on the pool.

Sampling is greedy in this slice: the engine's runner refuses a row with
temperature > 0 (``NotImplementedError``) before it reaches the step, so
``sample_tokens`` takes the argmax.  The (B, 2) key slot is kept so the
signatures match the reference and may hold zeros.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.transformer import check_supported, unstack_layers


def supports_paged(cfg: ModelConfig) -> bool:
    return (cfg.layer_pattern == "uniform" and cfg.mla is None
            and not cfg.encoder_decoder)


def page_tile(n_pages: int) -> int:
    """Pages per tile of the reference kernel: the largest of {4, 2, 1}
    dividing n_pages.  The port's kernel walks its own tiles; this only
    sets the page padding that a ctx == 0 row sees."""
    for p in (4, 2):
        if n_pages % p == 0 and n_pages >= p:
            return p
    return 1


def _decode_hidden(params, pool, block_tables, context_lens, tokens,
                   cfg: ModelConfig):
    """Shared decode body up to the final norm: one token per row through
    the paged pool.  Returns (x_last (B, d), pool) — the pool is written
    in place (each row's new K/V at position ``context_lens``)."""
    check_supported(cfg)
    B = tokens.shape[0]
    bs = pool.shape[3]
    n_pages = block_tables.shape[1]
    x = L.embed(params["embed"], tokens[:, None])          # (B, 1, d)
    positions = context_lens[:, None]                      # rope positions
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    ppcb = page_tile(n_pages)
    # the reference's gather clamps an out-of-table page index; so does
    # this one (only a padding row can reach it)
    page = torch.clamp(context_lens // bs, max=n_pages - 1).long()
    blk = block_tables.gather(1, page[:, None])[:, 0].long()
    off = (context_lens % bs).long()
    ctx1 = context_lens + 1
    for layer, lp in enumerate(unstack_layers(params["layers"])):
        pool_l = pool[layer]                               # (2, nb, bs, H, D)
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = attn._project_qkv(lp["attn"], h, cfg)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        pool_l[0, blk, off] = k[:, 0].to(pool.dtype)
        pool_l[1, blk, off] = v[:, 0].to(pool.dtype)
        a = ops.paged_attention(q[:, 0].contiguous(), pool_l[0], pool_l[1],
                                block_tables, ctx1, scale,
                                pages_per_compute_block=ppcb)
        x = x + (a.reshape(B, 1, -1) @ lp["attn"]["wo"].to(x.dtype))
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + L.swiglu(lp["ffn"], h)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x[:, 0], pool


def sample_tokens(logits, keys, ctx, sampling):
    """Greedy next tokens (B,) int32: the argmax, first maximum on ties,
    as ``jnp.argmax``.  ``keys`` (B, 2), ``ctx`` (B,) and ``sampling``
    (B, 3) [temperature, top_k, top_p] keep the reference's signature;
    rows with temperature > 0 are refused upstream, by the runner, where
    the value is known on the host."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


def _device_step_core(params, pool, block_tables, context_lens, tokens,
                      active, keys, sampling, cfg: ModelConfig):
    """One decode step.  Returns (next_tokens, pool, new_ctx, new_tokens);
    ``pool``, ``context_lens`` and ``tokens`` are updated in place."""
    x_last, pool = _decode_hidden(params, pool, block_tables, context_lens,
                                  tokens, cfg)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = L.unembed(head, x_last)
    nxt = sample_tokens(logits, keys, context_lens, sampling)
    context_lens.add_(active.to(context_lens.dtype))
    tokens.copy_(torch.where(active, nxt, tokens))
    return nxt, pool, context_lens, tokens


def paged_decode_step_device(params, pool, block_tables, context_lens,
                             tokens, active, keys, sampling, *,
                             cfg: ModelConfig):
    """Device-resident decode step for the DecodeRunner.

    pool: (L, 2, nb, bs, Hkv, D) bf16; block_tables: (B, n_pages) int32;
    context_lens: (B,) int32 tokens already cached; tokens: (B,) int32
    current inputs; active: (B,) bool rows decoding this step (inactive
    rows keep their state; their trash-directed compute is discarded);
    keys: (B, 2); sampling: (B, 3) f32.  pool, context_lens and tokens
    are written in place (the reference donates them).
    Returns (next_tokens, pool, context_lens, tokens)."""
    return _device_step_core(params, pool, block_tables, context_lens,
                             tokens, active, keys, sampling, cfg)


def _prefill_chunk_core(params, tokens, k_carry, v_carry, prefix_len: int,
                        chunk_len: int, cfg: ModelConfig):
    """One chunk of a position-masked chunked prefill.  tokens: (1, C_pad)
    int; k_carry/v_carry: (L, S_pad, Hkv, D) with rows [0, prefix_len)
    holding the earlier chunks' K/V.  The chunk's K/V is written into the
    carries at ``prefix_len`` BEFORE attention, so query i (position
    prefix_len + i) attends keys [0, prefix_len + i] of one buffer.
    Returns (last_logits (V,) at position prefix_len + chunk_len - 1,
    k_carry, v_carry)."""
    check_supported(cfg)
    B, C_pad = tokens.shape
    S_pad = k_carry.shape[1]
    dev = tokens.device
    x = L.embed(params["embed"], tokens)                   # (1, C_pad, d)
    positions = prefix_len + torch.arange(C_pad, device=dev)[None, :]
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    mask = (torch.arange(S_pad, device=dev)[None, :]
            <= positions[0][:, None])[None, None]          # (1,1,C_pad,S_pad)
    for layer, lp in enumerate(unstack_layers(params["layers"])):
        kc, vc = k_carry[layer], v_carry[layer]            # (S_pad, H, D)
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = attn._project_qkv(lp["attn"], h, cfg)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        kc[prefix_len:prefix_len + C_pad] = k[0]
        vc[prefix_len:prefix_len + C_pad] = v[0]
        a = attn._sdpa(q, kc[None], vc[None], mask, scale)
        x = x + (a.reshape(B, C_pad, -1) @ lp["attn"]["wo"].to(x.dtype))
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + L.swiglu(lp["ffn"], h)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    # unembed ONLY the last real position
    x_last = x[0, chunk_len - 1:chunk_len]                 # (1, d)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return L.unembed(head, x_last)[0], k_carry, v_carry


def prefill_kv_chunk(params, tokens, k_carry, v_carry, prefix_len: int,
                     chunk_len: int, *, cfg: ModelConfig):
    """One chunk of a position-masked chunked prefill (see
    ``_prefill_chunk_core``); the carries are written in place (the
    reference donates them).  ``kernels.ops.prefill_chunk`` owns the
    pow2 bucketing of C_pad and S_pad."""
    return _prefill_chunk_core(params, tokens, k_carry, v_carry,
                               prefix_len, chunk_len, cfg)
