"""Block copies over KV pools: the CUDA kernels' wrappers, their plain
versions, and the run-list helpers.

Counterpart of ``repro/kernels/block_copy.py``:

* the run-coalesced copy of the swap data plane (``_copy_runs_3d``,
  ``block_gather_runs``, ``block_scatter_runs``): runs
  ``src[:, s:s+l] -> dst[:, d:d+l]`` over (C, n_blocks, E) views of a pool
  or staging slab, with C = L * 2 (layer, k/v) planes;
* ``block_copy``, the per-block copy ``dst[dst_blocks[i]] =
  src[src_blocks[i]]`` over (nb, E) pools (the vLLM per-block baseline);
* ``block_copy_grouped``, the same run copy over (nb, E) pools;
* ``runs_to_indices``, ``trim_runs``, ``split_runs``.

Zero-length runs copy nothing and blocks no step names keep their bytes.
Every copy is in place on ``dst``, which the wrappers also return, so call
sites read like the reference's "returns the new array" form.  Block
indices follow the TPU kernels' index maps: int32 ``start + j``, a
negative index counts from the end of the pool, then the index is clamped
into the pool.  Every copy also keeps the sequential TPU grid's result
where several steps name one destination block (a run past the end of a
pool clamps its last steps onto one block): the last step's bytes win.

On CPU tensors the wrappers take the plain version; on CUDA tensors they
launch ``csrc/block_copy.cu`` or raise.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from repro_torch.kernels import build, launches


def copy_runs_plain(src, dst, src_starts, dst_starts, run_lens,
                    run_blocks: int):
    """Plain version of the run copy over C planes: the per-plane rule of
    ``block_copy_grouped_plain`` (grid steps j < min(len_r, run_blocks),
    the TPU index rule, the last step naming a block wins) applied to
    every plane at once.  src: (C, n_src, ...); dst: (C, n_dst, ...);
    starts/lens: (n_runs,) ints.  Writes ``dst`` in place and returns
    it."""
    block_copy_grouped_plain(src.transpose(0, 1), dst.transpose(0, 1),
                             src_starts, dst_starts, run_lens, run_blocks)
    return dst


def _check_copy_args(src, dst, idx, what: str) -> None:
    if not all(t.is_cuda and t.device == src.device for t in (dst, *idx)):
        raise ValueError(f"{what}: all operands must be on one CUDA device")
    if src.dtype != dst.dtype:
        raise TypeError(f"{what}: src {src.dtype} != dst {dst.dtype}")
    if any(t.dtype != torch.int32 for t in idx):
        raise TypeError(f"{what}: block indices must be int32")
    if not (src.is_contiguous() and dst.is_contiguous()
            and all(t.is_contiguous() for t in idx)):
        raise ValueError(f"{what}: operands must be contiguous")
    if src.untyped_storage().data_ptr() == dst.untyped_storage().data_ptr():
        raise ValueError(f"{what}: src and dst share memory; the kernel "
                         "reads src while it writes dst")


def _copy_runs_cuda(src, dst, src_starts, dst_starts, run_lens,
                    run_blocks: int, what: str) -> bool:
    """Launch the run-copy kernel over (C, n, ...) planes, with int32
    scratch for its last-write pass; False where there is nothing to
    copy."""
    idx = (src_starts, dst_starts, run_lens)
    _check_copy_args(src, dst, idx, what)
    n_runs = src_starts.shape[0]
    if dst_starts.shape != (n_runs,) or run_lens.shape != (n_runs,):
        raise ValueError(f"{what}: starts and lens must be (n_runs,)")
    if src.shape[0] != dst.shape[0] or src.shape[2:] != dst.shape[2:]:
        raise ValueError(f"{what}: src {tuple(src.shape)} and dst "
                         f"{tuple(dst.shape)} differ outside the block axis")
    if not 0 < run_blocks <= 65535 or n_runs * run_blocks >= 2 ** 31:
        raise ValueError(f"{what}: run_blocks {run_blocks} out of range")
    row_bytes = math.prod(src.shape[2:]) * src.element_size()
    if 0 in (n_runs, src.shape[1], dst.shape[1], row_bytes):
        return False
    winner = torch.empty((dst.shape[1],), dtype=torch.int32,
                         device=dst.device)
    lib = build.library("block_copy")
    code = lib.fs_copy_runs(
        src.data_ptr(), dst.data_ptr(), src_starts.data_ptr(),
        dst_starts.data_ptr(), run_lens.data_ptr(), n_runs, run_blocks,
        src.shape[0], src.shape[1], dst.shape[1], row_bytes,
        winner.data_ptr(), torch.cuda.current_stream(src.device).cuda_stream)
    build.check_launch(code, what)
    return True


def block_gather_runs(pool, slab0, src_starts, dst_starts, run_lens,
                      run_blocks: int):
    """Gather contiguous pool runs into a staging slab:
    pool[:, s:s+l] -> slab[:, d:d+l] per run (the d2h half of the staged
    swap path: the slab then crosses the host link as ONE transfer).

    pool: (C, nb, ...) and slab0: (C, n_slab, ...) with the same trailing
    block layout; ``run_blocks``: the grid's per-run extent (steps j >=
    len copy nothing).  Writes ``slab0`` in place and returns it.  A
    tensor-parallel shard's pool (C, nb, bs, Hkv / M, D) is such a layout:
    its local heads are flattened into the block rows the kernel moves,
    so one launch moves one shard's heads (reference
    ``repro/kernels/block_copy.py:150-190``).

    CPU tensors take ``copy_runs_plain``; CUDA tensors launch the run-copy
    kernel over the C planes, after a pass that picks the last step
    naming each destination block."""
    launches.refuse_shapes_only("block_gather_runs", pool, slab0)
    if not pool.is_cuda:
        return copy_runs_plain(pool, slab0, src_starts, dst_starts, run_lens,
                               run_blocks)
    if _copy_runs_cuda(pool, slab0, src_starts, dst_starts, run_lens,
                       run_blocks, "block_gather_runs"):
        launches.count(block_gather_runs, on=pool)
    return slab0


def block_scatter_runs(slab, pool, src_starts, dst_starts, run_lens,
                       run_blocks: int):
    """Scatter a staging slab back into pool runs:
    slab[:, s:s+l] -> pool[:, d:d+l] per run (the h2d half of the staged
    swap path).  Writes ``pool`` in place and returns it; CPU and CUDA
    tensors as in ``block_gather_runs``."""
    launches.refuse_shapes_only("block_scatter_runs", slab, pool)
    if not pool.is_cuda:
        return copy_runs_plain(slab, pool, src_starts, dst_starts, run_lens,
                               run_blocks)
    if _copy_runs_cuda(slab, pool, src_starts, dst_starts, run_lens,
                       run_blocks, "block_scatter_runs"):
        launches.count(block_scatter_runs, on=pool)
    return pool


block_gather_runs.launches = 0
block_scatter_runs.launches = 0


def _block_index(idx, n: int):
    """The TPU index map's block for int64 ``idx``: wrapped to int32, a
    negative index counts from the end, then clamped into [0, n)."""
    idx = (idx + 2 ** 31) % 2 ** 32 - 2 ** 31
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def block_copy_plain(src_pool, dst_pool, src_blocks, dst_blocks):
    """Plain version: ``dst_pool[d_i] = src_pool[s_i]`` with the TPU index
    rule; where several pairs name one destination block the last pair
    wins.  src_pool: (nb_src, ...); dst_pool: (nb_dst, ...); indices:
    (n,) ints.  Writes ``dst_pool`` in place and returns it."""
    n = src_blocks.shape[0]
    if n == 0 or src_pool.shape[0] == 0 or dst_pool.shape[0] == 0:
        return dst_pool
    dev = dst_pool.device
    si = _block_index(src_blocks.to(dev, torch.int64), src_pool.shape[0])
    di = _block_index(dst_blocks.to(dev, torch.int64), dst_pool.shape[0])
    order = torch.arange(n, device=dev)
    last = torch.full((dst_pool.shape[0],), -1, dtype=torch.int64,
                      device=dev).scatter_reduce_(0, di, order, "amax")
    keep = last[di] == order
    dst_pool[di[keep]] = src_pool[si[keep]]
    return dst_pool


def block_copy(src_pool, dst_pool, src_blocks, dst_blocks):
    """Per-block copy ``dst_pool[dst_blocks[i]] = src_pool[src_blocks[i]]``
    over (nb, E) pools, in place on ``dst_pool`` (returned).  Indices:
    (n,) int32 on the pools' device.  Any row size.

    CPU tensors take ``block_copy_plain``; CUDA tensors launch the kernel
    (one CTA per index pair, after a pass that picks the last pair naming
    each destination block) and count it in ``block_copy.launches``."""
    launches.refuse_shapes_only("block_copy", src_pool, dst_pool)
    if not dst_pool.is_cuda:
        return block_copy_plain(src_pool, dst_pool, src_blocks, dst_blocks)
    what = "block_copy"
    _check_copy_args(src_pool, dst_pool, (src_blocks, dst_blocks), what)
    n = src_blocks.shape[0]
    if dst_blocks.shape != (n,) or src_blocks.dim() != 1:
        raise ValueError(f"{what}: src_blocks and dst_blocks must be (n,)")
    if src_pool.dim() != 2 or src_pool.shape[1:] != dst_pool.shape[1:]:
        raise ValueError(f"{what}: pools must be (nb, E) with one E, got "
                         f"{tuple(src_pool.shape)} and "
                         f"{tuple(dst_pool.shape)}")
    row_bytes = src_pool.shape[1] * src_pool.element_size()
    if n == 0 or row_bytes == 0 or 0 in (src_pool.shape[0],
                                         dst_pool.shape[0]):
        return dst_pool
    winner = torch.empty((dst_pool.shape[0],), dtype=torch.int32,
                         device=dst_pool.device)
    lib = build.library("block_copy")
    code = lib.fs_copy_blocks(
        src_pool.data_ptr(), dst_pool.data_ptr(), src_blocks.data_ptr(),
        dst_blocks.data_ptr(), n, src_pool.shape[0], dst_pool.shape[0],
        row_bytes, winner.data_ptr(),
        torch.cuda.current_stream(dst_pool.device).cuda_stream)
    build.check_launch(code, what)
    launches.count(block_copy)
    return dst_pool


def block_copy_grouped_plain(src_pool, dst_pool, src_starts, dst_starts,
                             run_lens, run_blocks: int):
    """Plain version: the grid's steps (run r, j < min(len_r, run_blocks))
    in the TPU kernel's order, each ``dst[d_r + j] = src[s_r + j]`` with
    the TPU index rule, as one per-block copy (the last step naming a
    block wins).  Writes ``dst_pool`` in place and returns it."""
    dev = dst_pool.device
    j = torch.arange(run_blocks, device=dev, dtype=torch.int64)[None, :]
    live = j < run_lens.to(dev, torch.int64)[:, None]
    si = (src_starts.to(dev, torch.int64)[:, None] + j)[live]
    di = (dst_starts.to(dev, torch.int64)[:, None] + j)[live]
    return block_copy_plain(src_pool, dst_pool, si, di)


def block_copy_grouped(src_pool, dst_pool, src_starts, dst_starts, run_lens,
                       run_blocks: int):
    """Grouped copy ``dst_pool[d:d+l] = src_pool[s:s+l]`` per run over
    (nb, E) pools, in place on ``dst_pool`` (returned).  starts / lens:
    (n_runs,) int32 on the pools' device; ``run_blocks``: the grid's
    per-run extent (steps j >= len copy nothing).  Any row size.

    CPU tensors take ``block_copy_grouped_plain``; CUDA tensors launch the
    run-copy kernel with one plane (C = 1), after a pass that picks the
    last step naming each destination block, and count it in
    ``block_copy_grouped.launches``."""
    launches.refuse_shapes_only("block_copy_grouped", src_pool, dst_pool)
    if not dst_pool.is_cuda:
        return block_copy_grouped_plain(src_pool, dst_pool, src_starts,
                                        dst_starts, run_lens, run_blocks)
    if src_pool.dim() != 2 or dst_pool.dim() != 2:
        raise ValueError(f"block_copy_grouped: pools must be (nb, E), got "
                         f"{tuple(src_pool.shape)} and "
                         f"{tuple(dst_pool.shape)}")
    if _copy_runs_cuda(src_pool[None], dst_pool[None], src_starts,
                       dst_starts, run_lens, run_blocks,
                       "block_copy_grouped"):
        launches.count(block_copy_grouped)
    return dst_pool


block_copy.launches = 0
block_copy_grouped.launches = 0


def runs_to_indices(runs: List[Tuple[int, int]]) -> List[int]:
    """Expand [(start, n)] runs to ONE flat per-block index list."""
    idx: List[int] = []
    for start, n in runs:
        idx.extend(range(start, start + n))
    return idx


def trim_runs(runs: List[Tuple[int, int]], n_blocks: int
              ) -> List[Tuple[int, int]]:
    """First ``n_blocks`` blocks of [(start, n)] runs (a partially backed
    transfer: the CPU copy may be shorter than the GPU allocation when
    contamination capped the reuse increment)."""
    out: List[Tuple[int, int]] = []
    for start, n in runs:
        if n_blocks <= 0:
            break
        take = min(n, n_blocks)
        out.append((start, take))
        n_blocks -= take
    return out


def split_runs(runs: List[Tuple[int, int]], chunk_blocks: int
               ) -> List[List[Tuple[int, int]]]:
    """Split [(start, n)] runs into chunks of <= chunk_blocks blocks each
    (a run crossing a chunk boundary is cut).  ``chunk_blocks <= 0``
    disables chunking.  The engine dispatches one swap task per chunk so
    a long transfer interleaves with decode steps instead of serializing
    behind the pool lock."""
    if chunk_blocks <= 0:
        return [list(runs)] if runs else []
    chunks: List[List[Tuple[int, int]]] = []
    cur: List[Tuple[int, int]] = []
    room = chunk_blocks
    for start, n in runs:
        while n > 0:
            take = min(n, room)
            cur.append((start, take))
            start += take
            n -= take
            room -= take
            if room == 0:
                chunks.append(cur)
                cur = []
                room = chunk_blocks
    if cur:
        chunks.append(cur)
    return chunks
