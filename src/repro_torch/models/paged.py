"""Paged-KV decode step and chunked prefill for the serving engine.

Counterpart of ``repro/models/paged.py`` (single-device branch).  Runs a
uniform GQA transformer (dense or MoE FFN) one token per sequence
against the paged pool through block tables, with the hand-written
paged-attention kernel.  A MoE layer routes every row of the step (or
every position of a padded prefill chunk) in one call, as the
reference's does, so its capacity counts padding rows too.
The engine pads the batch to a bucket; padding rows point their block
table at a reserved trash block and are masked by the caller.

Where the reference DONATES the pool, the context lengths, the last
tokens or the prefill carries, the port writes in place on the tensors it
was given and returns them, so the call sites keep the reference's
"rebind to the result" form.  The per-layer KV write is a plain in-place
index write on the pool; rows that share a slot (freed rows, on the trash
block) all write the last such row's K/V, so the pool's bytes do not
depend on the order in which the write's threads land.

The exact-shape ``paged_decode_step`` and ``prefill_kv`` run eagerly at
the shapes they are given: the parity reference and the engine's greedy
oracle, not the serving path.

Tensor parallelism (the reference's ``shard_map`` steps, ``:263-444``):
the decode step and the chunk forward take per-shard lists where the
mesh shards them (``models/sharding.py``): the parameter trees of
``shard_params``, the per-shard pools or carries over each shard's
local heads.  One body serves both paths, as in the reference: per
layer, each shard projects, rotates and writes its local heads and runs
the paged attention over them; the head outputs are concatenated in
shard order (the reference's all-gather) before the replicated ``wo``,
MLP or MoE and norms, which run once (the shards share one device,
``launch/mesh.py``).  A tensor (not a list) is the one-device path, the
code that ran before the mesh.

Sampling (temperature / top-k / top-p) is fused into the step as in the
reference, with the reference's random streams (``models/prng.py``).  The
reference keeps an all-greedy step argmax-only through a batch-level
``lax.cond``; a captured CUDA graph cannot branch on a device value, so
the step takes ``sampled`` instead, fixed per captured variant: the
runner knows on the host whether any active row samples.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import prng
from repro_torch.models.sharding import is_sharded, unshard
from repro_torch.models.transformer import (check_supported, ffn,
                                            forward_seq, unstack_layers)


def supports_paged(cfg: ModelConfig) -> bool:
    return (cfg.layer_pattern == "uniform" and cfg.mla is None
            and not cfg.encoder_decoder)


def check_paged(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless the paged path serves ``cfg``:
    a uniform GQA decoder (the SSM, hybrid, gemma3, MLA and
    encoder-decoder families run through the contiguous-cache steps
    only, as in the reference)."""
    check_supported(cfg)
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the paged path serves uniform GQA decoders only")


def page_tile(n_pages: int) -> int:
    """Pages per tile of the reference kernel: the largest of {4, 2, 1}
    dividing n_pages.  The port's kernel walks its own tiles; this only
    sets the page padding that a ctx == 0 row sees."""
    for p in (4, 2):
        if n_pages % p == 0 and n_pages >= p:
            return p
    return 1


def shardable_heads(cfg: ModelConfig, n_shards: int) -> bool:
    """True when ``cfg``'s q and kv heads divide evenly over ``n_shards``
    model shards (the head-sharded serving layout's precondition)."""
    return (n_shards >= 1 and cfg.n_heads % n_shards == 0
            and cfg.n_kv_heads % n_shards == 0)


def shard_local_config(cfg: ModelConfig, n_shards: int) -> ModelConfig:
    """The per-shard view of ``cfg`` under ``n_shards``-way tensor
    parallelism over heads: q and kv head counts divided by the shard
    count (the GQA grouping kept), ``head_dim`` pinned to the resolved
    value so the division never changes it."""
    import dataclasses
    if n_shards == 1:
        return cfg
    if not shardable_heads(cfg, n_shards):
        raise ValueError(f"{cfg.name}: {cfg.n_heads} q / {cfg.n_kv_heads} kv "
                         f"heads do not divide over {n_shards} shards")
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // n_shards,
        n_kv_heads=cfg.n_kv_heads // n_shards,
        head_dim=cfg.resolved_head_dim)


def _shards(params, buffers):
    """(per-shard parameter trees, per-shard buffers, the replicated
    tree): a one-device call's single tree and tensor as one shard."""
    if not is_sharded(buffers):
        return [params], [buffers], params
    if len(params) != len(buffers):
        raise ValueError(f"{len(params)} parameter trees for "
                         f"{len(buffers)} shards")
    return list(params), list(buffers), params[0]


def _decode_hidden(params, pool, block_tables, context_lens, tokens,
                   cfg: ModelConfig):
    """Shared decode body up to the final norm: one token per row through
    the paged pool.  Returns (x_last (B, d), pool) — the pool is written
    in place (each row's new K/V at position ``context_lens``).

    ``pool`` a per-shard list (and ``params`` the per-shard trees): each
    shard's projections, KV write and paged attention run over its local
    heads (``shard_local_config``), each attention launch on the
    one-device split-KV plan (``plan_kv_heads``), so each (row, head)
    walks the splits it walks in the one-device launch."""
    check_paged(cfg)
    shards, pools, rep = _shards(params, pool)
    local = shard_local_config(cfg, len(shards))
    B = tokens.shape[0]
    bs = pools[0].shape[3]
    n_pages = block_tables.shape[1]
    x = L.embed(rep["embed"], tokens[:, None])             # (B, 1, d)
    # the rotary tables of the step's positions, once for every layer
    cos, sin = L.rope_tables(context_lens[:, None], cfg.resolved_head_dim,
                             cfg.rope_theta)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    ppcb = page_tile(n_pages)
    # the reference's gather clamps an out-of-table page index; so does
    # this one (only a padding row can reach it)
    page = torch.clamp(context_lens // bs, max=n_pages - 1).long()
    blk = block_tables.gather(1, page[:, None])[:, 0].long()
    off = (context_lens % bs).long()
    # rows that share a slot (freed rows all write the trash block's first
    # slot) write the last such row's K/V, so the write does not depend on
    # the launch's order (a MoE row's K/V depends on the rows before it
    # through capacity); every live row owns its slot.  Every shard writes
    # the same row's heads there.
    slot = blk * bs + off
    rows = torch.arange(B, device=slot.device)
    last = torch.where(slot[:, None] == slot[None, :], rows, -1).amax(dim=1)
    ctx1 = context_lens + 1
    layers = [unstack_layers(p["layers"]) for p in shards]
    for layer, lp in enumerate(layers[0]):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        parts = []
        for shard, shard_pool in zip(layers, pools):
            pool_l = shard_pool[layer]                     # (2, nb, bs, H, D)
            q, k, v = attn._project_qkv(shard[layer]["attn"], h, local)
            q = L.rope_apply(q, cos, sin)
            k = L.rope_apply(k, cos, sin)
            pool_l[0, blk, off] = k[last, 0].to(pool_l.dtype)
            pool_l[1, blk, off] = v[last, 0].to(pool_l.dtype)
            parts.append(ops.paged_attention(
                q[:, 0].contiguous(), pool_l[0], pool_l[1], block_tables,
                ctx1, scale, pages_per_compute_block=ppcb,
                plan_kv_heads=cfg.n_kv_heads))
        a = unshard(parts, 1)
        x = x + (a.reshape(B, 1, -1) @ lp["attn"]["wo"].to(x.dtype))
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + ffn(lp, h, cfg)
    x = L.rmsnorm(rep["final_norm"], x, cfg.norm_eps)
    return x[:, 0], pool


def paged_decode_step(params, pool, block_tables, context_lens, tokens, *,
                      cfg: ModelConfig):
    """Exact-shape greedy decode step (reference
    ``repro/models/paged.py:185``, body ``_decode_core`` at ``:111``): no
    bucketing and no graph, so every call runs eagerly at the shapes it
    is given.  pool: (L, 2, nb, bs, Hkv, D), written in place (each row's
    new K/V at position ``context_lens``; the reference donates it);
    block_tables: (B, n_pages) int32; context_lens: (B,) tokens already
    cached; tokens: (B,) current input tokens.  Returns (next_tokens,
    logits (B, V) fp32, pool).  With ``prefill_kv`` and
    ``PagedPools.write_tokens``, the engine's schedule-independent greedy
    oracle."""
    x_last, pool = _decode_hidden(params, pool, block_tables, context_lens,
                                  tokens, cfg)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = L.unembed(head, x_last)
    return torch.argmax(logits, dim=-1).to(torch.int32), logits, pool


def sample_tokens(logits, keys, ctx, sampling, *, sampled: bool = True):
    """Fused temperature / top-k / top-p sampling, stateless per step.

    The per-row draw key is ``fold_in(keys[i], ctx[i])``: ``keys`` holds
    each row's position-independent base key (folded from (seed, rid)),
    so the stream is a pure function of (seed, rid, position).  Rows with
    ``temperature <= 0`` take the argmax, first maximum on ties, as
    ``jnp.argmax``.  The top-k and nucleus thresholds and the mask compare
    by value, so the order of tied logits in the sort does not matter.

    logits: (B, V); keys: (B, 2) int64 threefry words (``models/prng.py``);
    ctx: (B,) int positions; sampling: (B, 3) f32 per-row [temperature,
    top_k, top_p] (top_k 0 = disabled).  ``sampled=False`` is the
    argmax-only variant, for callers that know every row is greedy; it
    reads neither ``keys``, ``ctx`` nor ``sampling``.  Returns (B,) int32.
    Launches follow from shapes alone: no host synchronisation."""
    B, V = logits.shape
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not sampled:
        return greedy
    temp = sampling[:, 0]
    top_k = sampling[:, 1].to(torch.int32)
    top_p = sampling[:, 2]
    scaled = logits / torch.clamp(temp, min=1e-6)[:, None]
    sorted_lg = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.clamp(torch.where(top_k > 0, top_k, V), 1, V)
    kth = sorted_lg.gather(1, (k_eff - 1).long()[:, None])
    probs = torch.softmax(sorted_lg, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # nucleus: keep the smallest prefix whose mass reaches top_p (the
    # mass BEFORE an index must be < top_p; index 0 is always kept)
    keep = (cum - probs) < top_p[:, None]
    pth = torch.where(keep, sorted_lg, math.inf).min(dim=-1,
                                                     keepdim=True).values
    masked = torch.where(scaled >= torch.maximum(kth, pth), scaled,
                         -math.inf)
    g = prng.gumbel(prng.fold_in(keys, ctx), (V,))
    drawn = torch.argmax(masked + g, dim=-1).to(torch.int32)
    return torch.where(temp > 0.0, drawn, greedy)


def vocab_slices(table, x_last, n_shards: int):
    """The shards' logits of the reference's vocab-sharded unembed: shard s
    multiplies ``x_last`` (B, d) by its ``V / n_shards`` rows of ``table``
    (V, d), V divisible by ``n_shards``.  Returns n (B, V / n) fp32."""
    vs = table.shape[0] // n_shards
    return [L.unembed(None, x_last, table=table[s * vs:(s + 1) * vs])
            for s in range(n_shards)]


def vocab_sharded_greedy(table, x_last, n_shards: int) -> torch.Tensor:
    """The argmax of ``x_last @ table.T`` from the shards' vocab slices
    (``vocab_slices``): each shard's (max, argmax + its offset), then the
    first shard holding the maximum, so a tie goes to the lowest index,
    as one argmax over the full logits gives.  Returns (B,) int32."""
    local = vocab_slices(table, x_last, n_shards)
    vs = local[0].shape[1]
    vals = torch.stack([lg.amax(dim=-1) for lg in local])              # (n, B)
    idxs = torch.stack([torch.argmax(lg, dim=-1) + s * vs
                        for s, lg in enumerate(local)])                # (n, B)
    best = torch.argmax(vals, dim=0)                       # first max wins
    return idxs.gather(0, best[None, :])[0].to(torch.int32)


def _device_step_core(params, pool, block_tables, context_lens, tokens,
                      active, keys, sampling, cfg: ModelConfig,
                      sampled: bool = True):
    """One decode step.  Returns (next_tokens, pool, new_ctx, new_tokens);
    ``pool``, ``context_lens`` and ``tokens`` are updated in place.  The
    runner captures this body as a CUDA graph per bucket and variant, so
    it must not synchronise with the host: every launch follows from
    shapes and ``sampled`` alone.

    With per-shard lists over n > 1 shards and a vocabulary divisible by
    n, the unembed is vocab-sharded as in the reference: the argmax-only
    variant combines the shards' (max, argmax) pairs
    (``vocab_sharded_greedy``), the sampled variant concatenates the
    shards' logits and samples them once; otherwise it is replicated."""
    x_last, pool = _decode_hidden(params, pool, block_tables, context_lens,
                                  tokens, cfg)
    shards, _, rep = _shards(params, pool)
    n = len(shards)
    head = rep["embed"] if cfg.tie_embeddings else rep["lm_head"]
    vocab_sharded = n > 1 and cfg.vocab_size % n == 0
    if vocab_sharded and not sampled:
        nxt = vocab_sharded_greedy(head["table"], x_last, n)
    else:
        logits = (unshard(vocab_slices(head["table"], x_last, n), 1)
                  if vocab_sharded else L.unembed(head, x_last))
        nxt = sample_tokens(logits, keys, context_lens, sampling,
                            sampled=sampled)
    context_lens.add_(active.to(context_lens.dtype))
    tokens.copy_(torch.where(active, nxt, tokens))
    return nxt, pool, context_lens, tokens


def paged_decode_step_device(params, pool, block_tables, context_lens,
                             tokens, active, keys, sampling, *,
                             cfg: ModelConfig, sampled: bool = True):
    """Device-resident decode step for the DecodeRunner.

    pool: (L, 2, nb, bs, Hkv, D) bf16; block_tables: (B, n_pages) int32;
    context_lens: (B,) int32 tokens already cached; tokens: (B,) int32
    current inputs; active: (B,) bool rows decoding this step (inactive
    rows keep their state; their trash-directed compute is discarded);
    keys: (B, 2) int64 per-row base threefry keys; sampling: (B, 3) f32
    per-row [temperature, top_k, top_p]; ``sampled=False``: the
    argmax-only variant, valid when no row has temperature > 0.  pool,
    context_lens and tokens are written in place (the reference donates
    them).  Returns (next_tokens, pool, context_lens, tokens).

    The mesh-sharded step (the reference's
    ``paged_decode_step_device_sharded``, ``:285-324``) is this one with
    ``params`` the per-shard trees of ``sharding.shard_params`` and
    ``pool`` the per-shard pools (L, 2, nb, bs, Hkv / M, D), every one
    written in place."""
    return _device_step_core(params, pool, block_tables, context_lens,
                             tokens, active, keys, sampling, cfg, sampled)


def prefill_kv(params, tokens, *, cfg: ModelConfig):
    """Full-context prefill returning per-layer K/V for pool insertion
    (reference ``repro/models/paged.py:325``), through the plain
    ``transformer.forward_seq``.  tokens: (1, T).  Returns (last_logits
    (V,), k, v: (L, T, Hkv, D)).  Exact-shape: the engine's runner
    prefills through the bucketed chunked forward instead; this is the
    parity reference and the prefill of one-shot tools."""
    logits, (k, v), _ = forward_seq(params, cfg, tokens)   # k: (L,1,T,H,D)
    return logits[0, -1], k[:, 0], v[:, 0]


def _prefill_chunk_core(params, tokens, k_carry, v_carry, prefix_len: int,
                        chunk_len: int, cfg: ModelConfig):
    """One chunk of a position-masked chunked prefill.  tokens: (1, C_pad)
    int; k_carry/v_carry: (L, S_pad, Hkv, D) with rows [0, prefix_len)
    holding the earlier chunks' K/V.  The chunk's K/V is written into the
    carries at ``prefix_len`` BEFORE attention, so query i (position
    prefix_len + i) attends keys [0, prefix_len + i] of one buffer.
    Per-shard carries (and ``params`` the per-shard trees): each shard
    projects its local heads and writes its carries; the attention then
    runs as one product over every shard's heads, the one-device
    product (over fewer heads cuBLAS may split the P.V reduction
    otherwise: at 512-token chunks on an H100 the shards' own products
    rounded up to 0.001 apart, PERF.md §6).
    Returns (last_logits (V,) at position prefix_len + chunk_len - 1,
    k_carry, v_carry)."""
    check_paged(cfg)
    shards, k_carries, rep = _shards(params, k_carry)
    v_carries = list(v_carry) if is_sharded(v_carry) else [v_carry]
    local = shard_local_config(cfg, len(shards))
    B, C_pad = tokens.shape
    S_pad = k_carries[0].shape[1]
    dev = tokens.device
    x = L.embed(rep["embed"], tokens)                      # (1, C_pad, d)
    positions = prefix_len + torch.arange(C_pad, device=dev)[None, :]
    cos, sin = L.rope_tables(positions, cfg.resolved_head_dim,
                             cfg.rope_theta)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    mask = (torch.arange(S_pad, device=dev)[None, :]
            <= positions[0][:, None])[None, None]          # (1,1,C_pad,S_pad)
    layers = [unstack_layers(p["layers"]) for p in shards]
    for layer, lp in enumerate(layers[0]):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        qs, kcs_l, vcs_l = [], [], []
        for shard, kcs, vcs in zip(layers, k_carries, v_carries):
            kc, vc = kcs[layer], vcs[layer]                # (S_pad, H, D)
            q, k, v = attn._project_qkv(shard[layer]["attn"], h, local)
            q = L.rope_apply(q, cos, sin)
            k = L.rope_apply(k, cos, sin)
            kc[prefix_len:prefix_len + C_pad] = k[0]
            vc[prefix_len:prefix_len + C_pad] = v[0]
            qs.append(q)
            kcs_l.append(kc)
            vcs_l.append(vc)
        a = attn._sdpa(unshard(qs, 2), unshard(kcs_l, 1)[None],
                       unshard(vcs_l, 1)[None], mask, scale)
        x = x + (a.reshape(B, C_pad, -1) @ lp["attn"]["wo"].to(x.dtype))
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + ffn(lp, h, cfg)
    x = L.rmsnorm(rep["final_norm"], x, cfg.norm_eps)
    # unembed ONLY the last real position
    x_last = x[0, chunk_len - 1:chunk_len]                 # (1, d)
    head = rep["embed"] if cfg.tie_embeddings else rep["lm_head"]
    return L.unembed(head, x_last)[0], k_carry, v_carry


def prefill_kv_chunk(params, tokens, k_carry, v_carry, prefix_len: int,
                     chunk_len: int, *, cfg: ModelConfig):
    """One chunk of a position-masked chunked prefill (see
    ``_prefill_chunk_core``); the carries are written in place (the
    reference donates them).  ``kernels.ops.prefill_chunk`` owns the
    pow2 bucketing of C_pad and S_pad.  With the per-shard trees and
    per-shard carries (L, S_pad, Hkv / M, D), the mesh-sharded chunk
    forward (the reference's ``prefill_kv_chunk_sharded``)."""
    return _prefill_chunk_core(params, tokens, k_carry, v_carry,
                               prefix_len, chunk_len, cfg)
