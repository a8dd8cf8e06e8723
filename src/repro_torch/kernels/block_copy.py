"""Run-coalesced block copy, the swap data plane: the CUDA kernel's
wrappers, their plain version, and the run-list helpers.

Counterpart of ``repro/kernels/block_copy.py`` (``_copy_runs_3d``,
``block_gather_runs``, ``block_scatter_runs``, ``runs_to_indices``,
``trim_runs``, ``split_runs``).  A run copy moves
``src[:, s:s+l] -> dst[:, d:d+l]`` for each run over (C, n_blocks, E)
views of a pool or staging slab, with C = L * 2 (layer, k/v) planes.
Zero-length runs copy nothing and blocks no run names keep their bytes.
The copy is in place on ``dst``, which the wrappers also return, so call
sites read like the reference's "returns the new array" form.

On CPU tensors the wrappers take the plain version; on CUDA tensors they
launch ``csrc/block_copy.cu`` or raise.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.kernels import build


def copy_runs_plain(src, dst, src_starts, dst_starts, run_lens):
    """Plain version: one slice copy per run.  src: (C, n_src, ...); dst:
    (C, n_dst, ...); starts/lens: (n_runs,) ints.  Writes ``dst`` in place
    and returns it."""
    for s, d, n in zip(src_starts.tolist(), dst_starts.tolist(),
                       run_lens.tolist()):
        if n > 0:
            dst[:, d:d + n] = src[:, s:s + n]
    return dst


def _copy_runs_cuda(src, dst, src_starts, dst_starts, run_lens,
                    run_blocks: int, what: str) -> None:
    idx = (src_starts, dst_starts, run_lens)
    if not all(t.is_cuda and t.device == src.device for t in (dst, *idx)):
        raise ValueError(f"{what}: all operands must be on one CUDA device")
    if src.dtype != dst.dtype:
        raise TypeError(f"{what}: src {src.dtype} != dst {dst.dtype}")
    if any(t.dtype != torch.int32 for t in idx):
        raise TypeError(f"{what}: starts and lens must be int32")
    if not (src.is_contiguous() and dst.is_contiguous()
            and all(t.is_contiguous() for t in idx)):
        raise ValueError(f"{what}: operands must be contiguous")
    n_runs = src_starts.shape[0]
    if dst_starts.shape != (n_runs,) or run_lens.shape != (n_runs,):
        raise ValueError(f"{what}: starts and lens must be (n_runs,)")
    if src.shape[0] != dst.shape[0] or src.shape[2:] != dst.shape[2:]:
        raise ValueError(f"{what}: src {tuple(src.shape)} and dst "
                         f"{tuple(dst.shape)} differ outside the block axis")
    C = src.shape[0]
    row_bytes = src[0, 0].numel() * src.element_size()
    if row_bytes % 16 or src.data_ptr() % 16 or dst.data_ptr() % 16:
        raise ValueError(f"{what}: block rows ({row_bytes} B) and base "
                         "pointers must be 16-byte multiples")
    if not 0 < run_blocks <= 65535:
        raise ValueError(f"{what}: run_blocks {run_blocks} out of range")
    if n_runs == 0 or src.shape[1] == 0 or dst.shape[1] == 0:
        return
    lib = build.library("block_copy")
    code = lib.fs_copy_runs(
        src.data_ptr(), dst.data_ptr(), src_starts.data_ptr(),
        dst_starts.data_ptr(), run_lens.data_ptr(), n_runs, run_blocks, C,
        src.shape[1], dst.shape[1], row_bytes,
        torch.cuda.current_stream(src.device).cuda_stream)
    build.check_launch(code, what)


def block_gather_runs(pool, slab0, src_starts, dst_starts, run_lens,
                      run_blocks: int):
    """Gather contiguous pool runs into a staging slab:
    pool[:, s:s+l] -> slab[:, d:d+l] per run (the d2h half of the staged
    swap path: the slab then crosses the host link as ONE transfer).

    pool: (C, nb, ...) and slab0: (C, n_slab, ...) with the same trailing
    block layout; ``run_blocks``: the grid's per-run extent (>= every
    run's length).  Writes ``slab0`` in place and returns it."""
    if not pool.is_cuda:
        return copy_runs_plain(pool, slab0, src_starts, dst_starts, run_lens)
    _copy_runs_cuda(pool, slab0, src_starts, dst_starts, run_lens,
                    run_blocks, "block_gather_runs")
    block_gather_runs.launches += 1
    return slab0


def block_scatter_runs(slab, pool, src_starts, dst_starts, run_lens,
                       run_blocks: int):
    """Scatter a staging slab back into pool runs:
    slab[:, s:s+l] -> pool[:, d:d+l] per run (the h2d half of the staged
    swap path).  Writes ``pool`` in place and returns it."""
    if not pool.is_cuda:
        return copy_runs_plain(slab, pool, src_starts, dst_starts, run_lens)
    _copy_runs_cuda(slab, pool, src_starts, dst_starts, run_lens,
                    run_blocks, "block_scatter_runs")
    block_scatter_runs.launches += 1
    return pool


block_gather_runs.launches = 0
block_scatter_runs.launches = 0


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
