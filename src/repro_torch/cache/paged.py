"""Paged KV cache pools (device + host) and the staged swap plane.

Counterpart of ``repro/cache/paged.py`` (single device).  The device pool
is a bf16 tensor of shape (L, 2, num_blocks, block_size, Hkv, D) (2 = K/V);
the host pool ``cpu`` is a numpy uint16 array of the bf16 BIT PATTERN
(the engine indexes it as numpy).  On CUDA the host pool and the staging
slabs live in pinned memory, so the d2h and h2d legs are real async DMA.

The engine's swap path (``copy_out_staged`` / ``copy_in_staged``): the
run-copy kernel stages a request's blocks into one contiguous device slab,
the slab crosses the host link as a SINGLE transfer, and the swap-in
scatter writes the pool in place.  Callers serialize under the engine's
pool lock.  Residency contract: both calls synchronise the stream before
they return, so a swap task's future completing means the bytes have
landed, and a pinned staging slab outlives its non-blocking copy.

``with_data=False`` gives bookkeeping-only pools for trace-driven runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops


@dataclass
class PoolSpec:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    block_size: int          # tokens per block
    num_gpu_blocks: int
    num_cpu_blocks: int
    dtype: str = "bfloat16"

    @classmethod
    def from_config(cls, cfg: ModelConfig, num_gpu_blocks: int,
                    num_cpu_blocks: int, block_size: int = 16) -> "PoolSpec":
        return cls(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                   head_dim=cfg.resolved_head_dim, block_size=block_size,
                   num_gpu_blocks=num_gpu_blocks,
                   num_cpu_blocks=num_cpu_blocks)

    def block_bytes(self) -> int:
        """Bytes of ONE block across all layers and K+V (what one swap of
        one block moves)."""
        itemsize = 2 if self.dtype == "bfloat16" else 4
        return (self.n_layers * 2 * self.block_size * self.n_kv_heads
                * self.head_dim * itemsize)


def _host_uint16(shape, pinned: bool) -> Tuple[np.ndarray, torch.Tensor]:
    """A zeroed host uint16 array and the torch tensor that owns its
    memory (pinned on CUDA hosts; ``pin_memory`` raises without CUDA)."""
    t = torch.zeros(shape, dtype=torch.int16, pin_memory=pinned)
    return t.numpy().view(np.uint16), t


class PagedPools:
    def __init__(self, spec: PoolSpec, with_data: bool = True,
                 device="cuda", stage_blocks: int = 16):
        """``stage_blocks``: granularity of ``copy_in_staged`` — a swap-in
        larger than this many blocks is uploaded in stage-sized sub-slabs,
        so the host gather and h2d of sub-slab k+1 overlap the scatter of
        sub-slab k on the device.  Each sub-slab counts as its own staged
        call.  <= 0 disables the split."""
        self.spec = spec
        self.with_data = with_data
        self.stage_blocks = stage_blocks
        self.device = torch.device(device)
        self.n_shards = 1
        # host-transfer accounting: each count is one device<->host hop
        self.d2h_transfers = 0
        self.h2d_transfers = 0
        self.staged_out_calls = 0
        self.staged_in_calls = 0
        self._pinned = self.device.type == "cuda"
        if with_data:
            s = spec
            self.gpu = torch.zeros((s.n_layers, 2, s.num_gpu_blocks,
                                    s.block_size, s.n_kv_heads, s.head_dim),
                                   dtype=torch.bfloat16, device=self.device)
            self.cpu, self._cpu_owner = _host_uint16(
                (s.n_layers, 2, s.num_cpu_blocks, s.block_size,
                 s.n_kv_heads, s.head_dim), self._pinned)
        else:
            self.gpu = None
            self.cpu = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # -- staged data plane (the engine's swap path) -----------------------

    def copy_out_staged(self, gpu_runs: Sequence[Tuple[int, int]],
                        cpu_blocks: List[int]) -> None:
        """GPU -> CPU via the device staging slab: one run-copy gather
        coalesces ``gpu_runs`` [(start, n)] into a contiguous slab, then
        ONE d2h transfer moves the slab's used prefix; the host side is a
        single vectorized store of the bf16 bit pattern."""
        if not self.with_data or not gpu_runs:
            return
        slab, total = ops.gather_swap_runs(self.gpu, gpu_runs)
        if total != len(cpu_blocks):
            raise ValueError(f"{total} GPU blocks vs {len(cpu_blocks)} CPU")
        s = self.spec
        host, owner = _host_uint16((s.n_layers * 2, total, s.block_size,
                                    s.n_kv_heads, s.head_dim), self._pinned)
        owner.copy_(slab[:, :total].view(torch.int16),
                    non_blocking=self._pinned)
        self.staged_out_calls += 1
        self.d2h_transfers += 1
        self._sync()
        self.cpu[:, :, np.asarray(cpu_blocks)] = host.reshape(
            s.n_layers, 2, total, s.block_size, s.n_kv_heads, s.head_dim)

    def copy_in_staged(self, cpu_blocks: List[int],
                       gpu_runs: Sequence[Tuple[int, int]],
                       stage_blocks: Optional[int] = None) -> None:
        """CPU -> GPU via a host staging slab: a vectorized host gather,
        ONE h2d transfer per sub-slab, then a run-copy scatter into the
        pool in place.  Callers must hold the engine's pool lock.

        A call larger than ``stage_blocks`` (ctor default) is split into
        stage-sized sub-slabs: the h2d copies and scatters are queued on
        the stream without waiting, so sub-slab k+1's host gather runs
        while k uploads and scatters.  Each sub-slab counts as its own
        staged call (``h2d_transfers == staged_in_calls``).  One stream
        synchronise at the end keeps the residency contract and lets the
        pinned slabs go."""
        if not self.with_data or not gpu_runs:
            return
        s = self.spec
        total = sum(n for _, n in gpu_runs)
        if total != len(cpu_blocks):
            raise ValueError(f"{total} GPU blocks vs {len(cpu_blocks)} CPU")
        stage = self.stage_blocks if stage_blocks is None else stage_blocks
        if stage <= 0 or total <= stage:
            stages: List[List[Tuple[int, int]]] = [list(gpu_runs)]
        else:
            from repro_torch.kernels.block_copy import split_runs
            stages = split_runs(gpu_runs, stage)
        C = s.n_layers * 2
        staging = []            # pinned slabs in flight until the sync
        pos = 0
        for runs_c in stages:
            cnt = sum(n for _, n in runs_c)
            # zeros, not empty: the pow2 pad tail is masked off by the run
            # lengths, but it is uploaded and streamed through the kernel
            slab, owner = _host_uint16(
                (C, ops.slab_bucket_blocks(cnt), s.block_size,
                 s.n_kv_heads, s.head_dim), self._pinned)
            slab[:, :cnt] = self.cpu[
                :, :, np.asarray(cpu_blocks[pos:pos + cnt])].reshape(
                C, cnt, s.block_size, s.n_kv_heads, s.head_dim)
            pos += cnt
            dev = owner.to(self.device, non_blocking=self._pinned)
            staging.append(owner)
            self.staged_in_calls += 1
            self.h2d_transfers += 1
            self.gpu = ops.scatter_swap_runs(
                self.gpu, dev.view(torch.bfloat16), runs_c)
        self._sync()
        staging.clear()

    def read_tokens(self, block_ids: List[int], n_tokens: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gather (L, T, Hkv, D) K and V for the first n_tokens of a
        request (on the pool's device)."""
        if not self.with_data:
            raise ValueError("read_tokens needs a pool with data")
        bs = self.spec.block_size
        n_blocks = (n_tokens + bs - 1) // bs
        blocks = torch.as_tensor(list(block_ids[:n_blocks]), dtype=torch.long,
                                 device=self.device)
        g = self.gpu[:, :, blocks]                  # (L, 2, nb, bs, H, D)
        L, _, nb, _, H, D = g.shape
        flat = g.reshape(L, 2, nb * bs, H, D)[:, :, :n_tokens]
        return flat[:, 0], flat[:, 1]
