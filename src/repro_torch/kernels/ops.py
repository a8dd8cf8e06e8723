"""Public wrappers around the port's kernels, with the reference's pow2
bucketing.

Counterpart of ``repro/kernels/ops.py``.  PyTorch runs eagerly, so the
reference's ``jit`` wrappers map to plain calls, but the bucketing
functions (``_next_pow2``, ``slab_bucket_blocks``, ``_pad_runs``) stay:
the kernels' shapes follow them, as the reference's compiled variants
do.  Where the reference DONATES a buffer (the pool on a swap-in scatter
or a prefill insert, the prefill carries) the port writes in place on the
tensor it was given and returns it, so the call sites keep the reference's
"rebind to the result" form.

Under a tensor-parallel mesh (``launch/mesh.py``) the pool, the swap
slabs and the prefill carries are per-shard lists over each shard's
local heads (``models/sharding.py``).  The swap, insert and carry
functions take such a list where the reference takes a head-sharded
array, and run the one-shard function on each shard in turn: what the
reference's ``shard_map`` (or GSPMD, for the insert and the carry seed)
runs on every device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import block_copy as _bc
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gla_scan as _gla
from repro_torch.kernels import paged_attention as _pa
from repro_torch.models.sharding import CARRY_HEAD_AXIS, is_sharded


def paged_attention(q, k_pool, v_pool, block_tables, context_lens, scale,
                    pages_per_compute_block: int = 1,
                    plan_kv_heads: int = 0):
    return _pa.paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                               scale,
                               pages_per_compute_block=pages_per_compute_block,
                               plan_kv_heads=plan_kv_heads)


def flash_attention(q, k, v, *, causal=True, block_q=128, block_k=128):
    return _fa.flash_attention(q, k, v, causal=causal, block_q=block_q,
                               block_k=block_k)


def _blocks_on(blocks, device) -> torch.Tensor:
    """Block indices (a sequence or a tensor) as int32 on ``device``."""
    if isinstance(blocks, torch.Tensor):
        return blocks.to(device, torch.int32).contiguous()
    return to_device(np.asarray(blocks, np.int32).reshape(-1), device)


def copy_blocks(src_pool, dst_pool, src_blocks, dst_blocks):
    """Per-block scattered copy (vLLM baseline data plane):
    dst_pool[dst_blocks[i]] = src_pool[src_blocks[i]], in place on
    ``dst_pool`` (the reference aliases it), which is returned."""
    dev = dst_pool.device
    return _bc.block_copy(src_pool, dst_pool, _blocks_on(src_blocks, dev),
                          _blocks_on(dst_blocks, dev))


def copy_block_runs(src_pool, dst_pool, runs: Sequence[Tuple[int, int]],
                    dst_starts: Sequence[int]):
    """Grouped copy: runs[i] = (src_start, n_blocks) -> dst_starts[i], in
    place on ``dst_pool``, which is returned."""
    if not runs:
        return dst_pool
    dev = dst_pool.device
    return _bc.block_copy_grouped(
        src_pool, dst_pool, _blocks_on([r[0] for r in runs], dev),
        _blocks_on(list(dst_starts), dev),
        _blocks_on([r[1] for r in runs], dev),
        run_blocks=max(1, int(max(r[1] for r in runs))))


def gla_scan_scalar(q, k, v, logw, *, chunk=64):
    """Chunked scalar-decay gated linear attention (Mamba2/SSD hot path)."""
    return _gla.gla_scan_scalar(q, k, v, logw, chunk=chunk)


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def slab_bucket_blocks(n_blocks: int) -> int:
    """Pow2 slab block count the staged swap kernels are bucketed to —
    the ONE place that defines it, so host-side staging buffers
    (``PagedPools.copy_in_staged``) can never diverge from the size the
    scatter checks against."""
    return _next_pow2(n_blocks)


def _pad_runs(runs: Sequence[Tuple[int, int]]
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int, int]:
    """Bucket one swap's runs for the staged copies: pad the run list to
    a pow2 count (zero-length runs copy nothing), size the slab and the
    per-run grid extent to pow2s.  Returns (src_starts, slab_offsets,
    lens, n_runs_pad, n_slab, run_blocks)."""
    n_runs = _next_pow2(len(runs))
    src = np.zeros((n_runs,), np.int32)
    dst = np.zeros((n_runs,), np.int32)
    lens = np.zeros((n_runs,), np.int32)
    off = 0
    for i, (start, n) in enumerate(runs):
        src[i] = start
        dst[i] = off
        lens[i] = n
        off += n
    return (src, dst, lens, n_runs, _next_pow2(off),
            _next_pow2(int(max(n for _, n in runs))))


# The padded shape keys each shape-keyed site has launched at: the port's
# counterparts of the reference's per-shape compiled variants (its
# ``jax.jit`` caches), read by ``launch/dryrun.py --audit-jit`` against
# fslint's FS002 bound.  Buckets keep each set O(log^2) of the sizes.
_SHAPE_KEYS = {"gather": set(), "scatter": set(), "insert": set()}


def swap_gather_cache_size() -> int:
    """Distinct padded shape keys of the staged gather (bucketing
    metric), every shard's together."""
    return len(_SHAPE_KEYS["gather"])


def swap_scatter_cache_size() -> int:
    """Distinct padded shape keys of the staged scatter."""
    return len(_SHAPE_KEYS["scatter"])


def insert_prefill_cache_size() -> int:
    """Distinct padded shape keys of the prefill scatter."""
    return len(_SHAPE_KEYS["insert"])


def prefill_chunk_cache_size() -> int:
    """Distinct padded shape keys of the chunked prefill forward
    (``models.paged.prefill_kv_chunk``), every shard's together."""
    from repro_torch.models.paged import prefill_chunk_keys
    return len(prefill_chunk_keys())


def reset_cache_sizes() -> None:
    """Forget every site's keys (the reference clears its jit caches)."""
    from repro_torch.models.paged import prefill_chunk_keys
    for keys in _SHAPE_KEYS.values():
        keys.clear()
    prefill_chunk_keys().clear()


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host index or token array as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _runs_on(device, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
    """Equal-length int32 run arrays as tensors on ``device``.  On CUDA
    they cross as one pinned, non-blocking copy on the current stream, so
    the host does not wait for that stream (a pageable copy would
    synchronise it); the pinned buffer's allocator keeps it until the
    copy is done."""
    host = torch.from_numpy(np.stack(arrays).astype(np.int32, copy=False))
    if torch.device(device).type != "cuda":
        return tuple(host.to(device))
    return tuple(host.pin_memory().to(device, non_blocking=True))


def gather_swap_runs(pool, runs: Sequence[Tuple[int, int]]):
    """Run-coalesced staged swap-out gather: copy the pool blocks named by
    ``runs`` [(start, n_blocks)] into one zeroed contiguous staging slab,
    so the d2h leg is a SINGLE transfer of the slab.

    pool: (L, 2, nb, bs, Hkv, D), read only.  Returns (slab, n_blocks)
    where slab is (L*2, n_slab_pow2, bs, Hkv, D); blocks [n_blocks:] are
    padding.  A per-shard pool list gives the per-shard slabs, each over
    its shard's heads (one transfer per shard)."""
    if not runs:
        raise ValueError("gather_swap_runs needs at least one run")
    if is_sharded(pool):
        slabs = [gather_swap_runs(p, runs)[0] for p in pool]
        return slabs, int(sum(n for _, n in runs))
    src, dst, lens, _, n_slab, run_blocks = _pad_runs(runs)
    slab = _gather_swap(pool, *_runs_on(pool.device, src, dst, lens),
                        n_slab=n_slab, run_blocks=run_blocks)
    return slab, int(sum(n for _, n in runs))


def _gather_swap(pool, src_starts, dst_starts, lens, *, n_slab: int,
                 run_blocks: int):
    """One shard's staged gather at one padded shape (the reference's
    jitted ``_gather_swap``): a zeroed (L*2, n_slab, bs, Hkv, D) slab
    filled by the run-copy kernel."""
    L, K, nb, bs, H, D = pool.shape
    _SHAPE_KEYS["gather"].add((tuple(pool.shape), str(pool.dtype),
                               src_starts.shape[0], n_slab, run_blocks))
    slab = torch.zeros((L * K, n_slab, bs, H, D), dtype=pool.dtype,
                       device=pool.device)
    _bc.block_gather_runs(pool.view(L * K, nb, bs, H, D), slab,
                          src_starts, dst_starts, lens, run_blocks=run_blocks)
    return slab


def scatter_swap_runs(pool, slab, runs: Sequence[Tuple[int, int]]):
    """Run-coalesced staged swap-in scatter: copy slab blocks [0, total)
    into the pool blocks named by ``runs``, in place on ``pool`` (the
    reference donates it).  slab: (L*2, n_slab_pow2, bs, Hkv, D).  A
    per-shard pool list takes the per-shard slabs, each shard scattering
    its local heads.  Returns ``pool``."""
    if not runs:
        raise ValueError("scatter_swap_runs needs at least one run")
    if is_sharded(pool):
        if len(slab) != len(pool):
            raise ValueError(f"{len(slab)} slabs for {len(pool)} shards")
        for p, sl in zip(pool, slab):
            scatter_swap_runs(p, sl, runs)
        return pool
    src, dst, lens, _, n_slab, run_blocks = _pad_runs(runs)
    if slab.shape[1] != n_slab:
        raise ValueError(f"slab holds {slab.shape[1]} blocks, the runs' "
                         f"bucket is {n_slab}")
    # gather offsets are the slab side here: slab[dst] -> pool[src]
    return _scatter_swap(pool, slab, *_runs_on(pool.device, dst, src, lens),
                         run_blocks=run_blocks)


def _scatter_swap(pool, slab, src_starts, dst_starts, lens, *,
                  run_blocks: int):
    """One shard's staged scatter at one padded shape (the reference's
    jitted ``_scatter_swap``), in place on ``pool``, which is returned."""
    L, K, nb, bs, H, D = pool.shape
    _SHAPE_KEYS["scatter"].add((tuple(pool.shape), str(pool.dtype),
                                tuple(slab.shape), src_starts.shape[0],
                                run_blocks))
    _bc.block_scatter_runs(slab, pool.view(L * K, nb, bs, H, D),
                           src_starts, dst_starts, lens,
                           run_blocks=run_blocks)
    return pool


def insert_prefill(pool, k, v, blocks, block_size: int):
    """Scatter block-aligned prefill K/V into the paged pool through a
    block-table row, in place on ``pool`` (returned).

    pool: (L, 2, nb, bs, Hkv, D); k, v: (L, T_pad, Hkv, D) with
    T_pad == len(blocks) * block_size (pad pages point at the trash
    block, the partial last real page is zero-padded — both beyond the
    context length).  blocks: (P,) page ids.  A per-shard pool list takes
    per-shard K/V lists (each over its shard's heads)."""
    if is_sharded(pool):
        for p, ks, vs in zip(pool, k, v):
            insert_prefill(p, ks, vs, blocks, block_size)
        return pool
    return _insert_prefill(pool, k, v,
                           to_device(np.asarray(blocks, np.int64),
                                     pool.device),
                           block_size=block_size)


def _insert_prefill(pool, k, v, blocks, *, block_size: int):
    """One shard's prefill scatter at one padded shape (the reference's
    jitted ``_insert_prefill``), in place on ``pool``, which is
    returned."""
    L, T, H, D = k.shape
    P = T // block_size
    _SHAPE_KEYS["insert"].add((tuple(pool.shape), str(pool.dtype),
                               tuple(k.shape), str(k.dtype), block_size))
    kv = torch.stack([k, v], dim=1).reshape(L, 2, P, block_size, H, D)
    pool[:, :, blocks] = kv.to(pool.dtype)
    return pool


# ---------------------------------------------------------------------------
# bucketed chunked prefill
# ---------------------------------------------------------------------------


def _zeros_carry(shape, device, mesh=None):
    """A zeroed bf16 prefill carry of the global ``shape``; with ``mesh``,
    the per-shard carries over each shard's heads, on its device."""
    if mesh is None:
        return torch.zeros(shape, dtype=torch.bfloat16, device=device)
    local = list(shape)
    local[CARRY_HEAD_AXIS] //= mesh.n_shards
    return [torch.zeros(local, dtype=torch.bfloat16, device=d)
            for d in mesh.shards]


def _grow_carry(carry, *, n_new: int):
    """Copy a (L, S_old, H, D) prefill carry into a longer zeroed buffer
    (pow2 token bucket); per-shard carries each."""
    if is_sharded(carry):
        return [_grow_carry(c, n_new=n_new) for c in carry]
    out = torch.zeros(carry.shape[:1] + (n_new,) + carry.shape[2:],
                      dtype=carry.dtype, device=carry.device)
    out[:, :carry.shape[1]] = carry
    return out


def _slice_tokens(kv, start: int, *, n: int):
    """(L, S_pad, H, D)[:, start:start+n] as a tensor of its own (the
    carry is written in place by later chunks); per shard for per-shard
    carries."""
    if is_sharded(kv):
        return [_slice_tokens(c, start, n=n) for c in kv]
    return kv[:, start:start + n].clone()


def prefill_chunk(params, tokens: Sequence[int], k_carry, v_carry,
                  prefix_len: int, *, cfg, block_size: int, mesh=None):
    """Bucketed wrapper around ``models.paged.prefill_kv_chunk``: pad the
    chunk to a pow2 token bucket (>= one page so the pool insert stays
    block-aligned), grow the carry buffers to a pow2 bucket holding
    ``prefix_len + chunk_pad`` tokens, and run the position-masked chunk
    forward.

    ``k_carry``/``v_carry``: None to start a prefill, else the buffers
    returned by the previous chunk (written in place — rebind).  Returns
    (last_logits, k_carry', v_carry', k_chunk, v_chunk) where k_chunk /
    v_chunk are (L, chunk_pad, Hkv, D) ready for ``insert_prefill``.
    With ``mesh`` (``params`` then the per-shard trees of
    ``sharding.shard_params``) the carries and chunks are per-shard lists
    over each shard's heads (the reference's sharded chunk forward)."""
    from repro_torch.models.paged import prefill_kv_chunk
    n = len(tokens)
    if n <= 0:
        raise ValueError("prefill_chunk needs at least one token")
    rep = params if mesh is None else params[0]
    device = rep["embed"]["table"].device
    c_pad = max(_next_pow2(n), block_size)
    toks = np.zeros((1, c_pad), np.int64)
    toks[0, :n] = tokens
    need = prefix_len + c_pad
    if k_carry is None:
        s_pad = _next_pow2(need)
        shape = (cfg.n_layers, s_pad, cfg.n_kv_heads, cfg.resolved_head_dim)
        k_carry = _zeros_carry(shape, device, mesh)
        v_carry = _zeros_carry(shape, device, mesh)
    elif (k_carry[0] if mesh is not None else k_carry).shape[1] < need:
        s_pad = _next_pow2(need)
        k_carry = _grow_carry(k_carry, n_new=s_pad)
        v_carry = _grow_carry(v_carry, n_new=s_pad)
    logits, k_carry, v_carry = prefill_kv_chunk(
        params, to_device(toks, device), k_carry, v_carry,
        prefix_len, n, cfg=cfg)
    k_chunk = _slice_tokens(k_carry, prefix_len, n=c_pad)
    v_chunk = _slice_tokens(v_carry, prefix_len, n=c_pad)
    return logits, k_carry, v_carry, k_chunk, v_chunk


def seed_prefill_carry(pool, block_ids: Sequence[int], start_tokens: int,
                       *, trash: int):
    """Initialize a chunked prefill's carry from KV already RESIDENT in
    the pool (the reuse mechanism's restored prefix), so chunking can
    start at ``start_tokens`` instead of recomputing the prefix.
    ``start_tokens`` must be block-aligned; the gathered page list is
    pow2-padded with trash pages whose rows sit at positions >=
    start_tokens and are overwritten by the chunk writes before any real
    query attends them.  Returns (k_carry, v_carry); per-shard lists for a
    per-shard pool list, each gathered from its shard's pool."""
    if is_sharded(pool):
        seeded = [seed_prefill_carry(p, block_ids, start_tokens, trash=trash)
                  for p in pool]
        return [k for k, _ in seeded], [v for _, v in seeded]
    bs = pool.shape[3]
    if start_tokens <= 0 or start_tokens % bs:
        raise ValueError(f"start_tokens {start_tokens} is not a positive "
                         f"multiple of the block size {bs}")
    nblk = start_tokens // bs
    blocks = np.full((_next_pow2(nblk),), trash, np.int64)
    blocks[:nblk] = list(block_ids)[:nblk]
    L, K, _, _, H, D = pool.shape
    kv = pool[:, :, to_device(blocks, pool.device)]
    kv = kv.reshape(L, K, blocks.shape[0] * bs, H, D)
    return kv[:, 0].contiguous(), kv[:, 1].contiguous()
