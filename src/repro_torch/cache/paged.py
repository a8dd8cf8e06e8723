"""Paged KV cache pools (device + host), the baseline data plane and the
staged swap plane.

Counterpart of ``repro/cache/paged.py``.  The device pool is a bf16
tensor of shape (L, 2, num_blocks, block_size, Hkv, D) (2 = K/V); under a
tensor-parallel mesh (``launch/mesh.py``) it is a list of per-shard
tensors (L, 2, num_blocks, block_size, Hkv / M, D), each over its
shard's heads on its shard's device (the reference's head-sharded
array).  The host pool ``cpu`` is a numpy uint16 array of the bf16 BIT
PATTERN in the full (L, 2, num_cpu_blocks, block_size, Hkv, D) layout
under every mesh, so swapped bytes compare across meshes (the engine
indexes it as numpy).  On CUDA the host pool and the staging
slabs live in pinned memory, so the d2h and h2d legs are real async DMA.

Two data planes, as in the reference:
  * ``copy_out`` / ``copy_in`` — the host-mediated baseline: a blocking
    index gather of the live pool and a d2h copy per call; ``copy_in``
    routes through the staged swap-in.  Kept for parity tests and as the
    per-block swap the paper measures FastSwitch against.
  * ``copy_out_staged`` / ``copy_in_staged`` — the engine's path: the
    run-copy kernel stages a request's blocks into one contiguous device
    slab, the slab crosses the host link as a SINGLE transfer, and the
    swap-in scatter writes the pool in place.  Callers serialize under
    the engine's pool lock.

Streams (CUDA).  Each pool owns the three streams its staged swaps use,
where the reference's transfers run on XLA's own transfer streams:
  * ``out``: the swap-out gather and its d2h copy.  The gather waits on
    an event of the caller's choosing (the engine records one on its
    stream when it dispatches the swap-out), never on the stream as a
    whole at the time a worker thread runs: that would also wait for the
    decode replays launched since.
  * ``h2d``: the swap-in's uploads, one per sub-slab, each marked by an
    event; and ``scatter``: the run-copy scatters, each waiting on its
    own upload's event, so the upload of sub-slab k+1 runs while
    sub-slab k scatters.
A swap-in's scatter writes blocks newly allocated to it.  Work on the
caller's stream issued before such a block was freed may still read or
write it (a decode replay in flight over a request just preempted), so
the owner of the block table reports every freed range through
``note_released``, which records an event on the caller's stream; a
scatter waits on the events of its target blocks that have not yet
completed, and on nothing else of the caller's stream.
Under a mesh, each staged chunk is one gather, one d2h and one h2d per
shard, on that shard's streams: ``d2h_transfers == n_shards *
staged_out_calls``, and the same for h2d, as in the reference.  Every
shard's scatter waits on the release events of its target blocks.
Residency contract: each staged call returns only once its own last
events have completed (the bytes are resident in the pool, or have landed
in ``cpu``), so a swap task's future completing means the data is there,
and the pinned staging buffers outlive their copies.

``with_data=False`` gives bookkeeping-only pools for trace-driven runs.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import check_one_device
from repro_torch.models.sharding import POOL_HEAD_AXIS, unshard


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


def _host_uint16(shape, pinned: bool, zero: bool = True
                 ) -> Tuple[np.ndarray, torch.Tensor]:
    """A host uint16 array and the torch tensor that owns its memory
    (pinned on CUDA hosts; ``pin_memory`` raises without CUDA); zeroed
    unless ``zero`` is False."""
    make = torch.zeros if zero else torch.empty
    t = make(shape, dtype=torch.int16, pin_memory=pinned)
    return t.numpy().view(np.uint16), t


def _kv_tensor(x, device) -> torch.Tensor:
    """K or V as a bf16 tensor on ``device``: a torch tensor as it is, or
    a numpy array (float values rounded to bf16; a bfloat16 array taken
    bit for bit)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.bfloat16)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=torch.bfloat16)


class PagedPools:
    def __init__(self, spec: PoolSpec, with_data: bool = True,
                 device="cuda", stage_blocks: int = 16, mesh=None):
        """``stage_blocks``: granularity of ``copy_in_staged`` — a swap-in
        larger than this many blocks is uploaded in stage-sized sub-slabs,
        so the host gather and upload of sub-slab k+1 overlap the scatter
        of sub-slab k on the device.  Each sub-slab counts as its own
        staged call.  <= 0 disables the split.

        ``mesh``: a ``ServingMesh`` (None: one device, on ``device``).
        The device pool is then one tensor per shard over its
        ``Hkv / n_shards`` heads, on the shard's device, and every staged
        swap runs per shard.  Shards must share one device."""
        self.spec = spec
        self.with_data = with_data
        self.stage_blocks = stage_blocks
        check_one_device(mesh)
        self.mesh = mesh
        self.n_shards = 1 if mesh is None else mesh.n_shards
        if spec.n_kv_heads % self.n_shards:
            raise ValueError(f"{spec.n_kv_heads} KV heads do not divide over "
                             f"{self.n_shards} shards")
        self.device = (torch.device(device) if mesh is None
                       else mesh.shards[0])
        # host-transfer accounting: each count is one device<->host hop
        # (a staged chunk moves one per shard, each 1/n_shards the bytes)
        self.d2h_transfers = 0
        self.h2d_transfers = 0
        self.staged_out_calls = 0
        self.staged_in_calls = 0
        # swap-ins whose scatter waited for work issued before one of its
        # target blocks was freed (``note_released``)
        self.fenced_swap_ins = 0
        self._pinned = self.device.type == "cuda"
        # bookkeeping-only pools touch no device; per shard, its (out,
        # h2d, scatter) streams
        cuda = self._pinned and with_data
        self._streams = [tuple(torch.cuda.Stream(self.device) if cuda
                               else None for _ in range(3))
                         for _ in range(self.n_shards)]
        self._out_stream, self._h2d_stream, self._scatter_stream = \
            self._streams[0]
        # block -> the event ``note_released`` recorded when it was freed
        self._released: Dict[int, torch.cuda.Event] = {}
        self._released_lock = threading.Lock()
        if with_data:
            s = spec
            hs = s.n_kv_heads // self.n_shards
            shape = (s.n_layers, 2, s.num_gpu_blocks, s.block_size, hs,
                     s.head_dim)
            if mesh is None:
                self.gpu = torch.zeros(shape, dtype=torch.bfloat16,
                                       device=self.device)
            else:
                self.gpu = [torch.zeros(shape, dtype=torch.bfloat16,
                                        device=d) for d in mesh.shards]
            self.cpu, self._cpu_owner = _host_uint16(
                (s.n_layers, 2, s.num_cpu_blocks, s.block_size,
                 s.n_kv_heads, s.head_dim), self._pinned)
        else:
            self.gpu = None
            self.cpu = None

    def _shards(self) -> List[Tuple[torch.Tensor, slice]]:
        """(pool, its heads of the host layout) per shard, in order."""
        if self.mesh is None:
            return [(self.gpu, slice(None))]
        hs = self.spec.n_kv_heads // self.n_shards
        return [(g, slice(i * hs, (i + 1) * hs))
                for i, g in enumerate(self.gpu)]

    def gpu_full(self) -> torch.Tensor:
        """The device pool in the full (L, 2, nb, bs, Hkv, D) layout: the
        pool itself on one device, the shards' heads concatenated in
        order (a copy) under a mesh."""
        return unshard([p for p, _ in self._shards()], POOL_HEAD_AXIS)

    def cpu_bf16(self) -> torch.Tensor:
        """The host pool reinterpreted as bfloat16 (a zero-copy torch view
        of ``cpu``; reference ``repro/cache/paged.py:116``)."""
        return torch.from_numpy(self.cpu.view(np.int16)).view(torch.bfloat16)

    # -- ordering against the caller's stream (CUDA) ----------------------

    def compute_event(self) -> Optional[torch.cuda.Event]:
        """An event recorded at the tail of the calling thread's current
        stream, for ``copy_out_staged(after=...)``; None off CUDA."""
        if self._out_stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def note_released(self, start: int, length: int) -> None:
        """Blocks [start, start + length) were freed: work issued so far
        on the calling thread's stream may still read or write them, so a
        later swap-in scattering into one of them waits for that work
        (and only that).  A no-op off CUDA, where the work is done."""
        if self._scatter_stream is None or length <= 0:
            return
        ev = self.compute_event()
        with self._released_lock:
            for b in range(start, start + length):
                self._released[b] = ev

    def _release_fences(self, blocks) -> List[torch.cuda.Event]:
        """The not-yet-completed release events of ``blocks`` (each
        taken off the record)."""
        with self._released_lock:
            evs = {id(e): e for e in (self._released.pop(b, None)
                                      for b in blocks) if e is not None}
        return [e for e in evs.values() if not e.query()]

    @staticmethod
    def _on(stream):
        return (torch.cuda.stream(stream) if stream is not None
                else contextlib.nullcontext())

    # -- baseline data plane (parity tests, the per-block swap) -----------

    def copy_out(self, gpu_blocks: List[int], cpu_blocks: List[int]) -> None:
        """GPU -> CPU block copy (d2h) — host-mediated baseline: one
        blocking index gather of the live pool and one d2h copy per call,
        on the caller's stream, then a store of the bf16 bit pattern
        (reference ``repro/cache/paged.py:122``)."""
        if not self.with_data:
            return
        idx = torch.as_tensor(np.asarray(gpu_blocks, np.int64),
                              device=self.device)
        g = unshard([p[:, :, idx] for p, _ in self._shards()],
                    POOL_HEAD_AXIS).cpu()
        self.cpu[:, :, np.asarray(cpu_blocks, np.int64)] = \
            g.view(torch.int16).numpy().view(np.uint16)

    def copy_in(self, cpu_blocks: List[int], gpu_blocks: List[int]) -> None:
        """CPU -> GPU block copy (h2d), routed through the staged path.
        Order-preserving run coalescing keeps the positional cpu<->gpu
        block pairing of the flat-list API (reference
        ``repro/cache/paged.py:130``)."""
        if not self.with_data or not gpu_blocks:
            return
        runs: List[Tuple[int, int]] = []
        for b in gpu_blocks:
            if runs and b == runs[-1][0] + runs[-1][1]:
                runs[-1] = (runs[-1][0], runs[-1][1] + 1)
            else:
                runs.append((b, 1))
        self.copy_in_staged(cpu_blocks, runs)

    # -- staged data plane (the engine's swap path) -----------------------

    def copy_out_staged(self, gpu_runs: Sequence[Tuple[int, int]],
                        cpu_blocks: List[int], *,
                        after: Optional[torch.cuda.Event] = None) -> None:
        """GPU -> CPU via the device staging slab: one run-copy gather
        coalesces ``gpu_runs`` [(start, n)] into a contiguous slab, then
        ONE d2h transfer moves the slab's used prefix; the host side is a
        single vectorized store of the bf16 bit pattern.  Under a mesh,
        one gather and one d2h per shard, each over its heads.

        On CUDA both run on the pool's ``out`` stream (each shard's own),
        after ``after``: an event marking the pool writes the gather must
        see (default: the caller's stream as it stands now).  Returns once
        the bytes are in ``cpu``."""
        if not self.with_data or not gpu_runs:
            return
        total = sum(n for _, n in gpu_runs)
        if total != len(cpu_blocks):
            raise ValueError(f"{total} GPU blocks vs {len(cpu_blocks)} CPU")
        if self._out_stream is not None and after is None:
            after = self.compute_event()
        s = self.spec
        staged = []             # (host slab, its heads, its d2h's event)
        for (pool, heads), (stream, _, _) in zip(self._shards(),
                                                 self._streams):
            done = None
            with self._on(stream):
                if stream is not None:
                    stream.wait_event(after)
                slab, _ = ops.gather_swap_runs(pool, gpu_runs)
                host, owner = _host_uint16((s.n_layers * 2, total)
                                           + tuple(slab.shape[2:]),
                                           self._pinned, zero=False)
                owner.copy_(slab[:, :total].view(torch.int16),
                            non_blocking=self._pinned)
                if stream is not None:
                    done = torch.cuda.Event()
                    done.record(stream)
            staged.append((host, heads, done))
            self.d2h_transfers += 1
        self.staged_out_calls += 1
        ids = np.asarray(cpu_blocks)
        for host, heads, done in staged:
            if done is not None:
                done.synchronize()
            self.cpu[:, :, ids, :, heads] = host.reshape(
                (s.n_layers, 2) + host.shape[1:])

    def copy_in_staged(self, cpu_blocks: List[int],
                       gpu_runs: Sequence[Tuple[int, int]],
                       stage_blocks: Optional[int] = None) -> None:
        """CPU -> GPU via a host staging slab: a vectorized host gather,
        ONE h2d transfer per sub-slab, then a run-copy scatter into the
        pool in place.  Callers must hold the engine's pool lock.  Under a
        mesh, each sub-slab is one host gather, one h2d and one scatter
        per shard, each over its heads.

        A call larger than ``stage_blocks`` (ctor default) is split into
        stage-sized sub-slabs, each its own staged call (``h2d_transfers
        == n_shards * staged_in_calls``).  On CUDA the uploads run on the
        pool's ``h2d`` stream and the scatters on its ``scatter`` stream
        (each shard's own), each scatter after its own upload's event;
        scatter k is issued once upload k+1 is queued, so the upload of
        sub-slab k+1 runs while sub-slab k scatters (and the host gathers
        sub-slab k+2).  Every shard's scatters also wait for the release
        events of their target blocks (``note_released``).  Returns once
        the last scatters' events have completed: the bytes are resident,
        and the pinned slabs can go."""
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
        shards = self._shards()
        if self._scatter_stream is not None:
            fences = self._release_fences(
                b for start, n in gpu_runs for b in range(start, start + n))
            for _, _, sc in self._streams:
                for ev in fences:
                    sc.wait_event(ev)
            self.fenced_swap_ins += bool(fences)
        C = s.n_layers * 2
        hs = s.n_kv_heads // self.n_shards
        staging = []            # pinned slabs in flight until the last event
        queued = None           # (per shard (device slab, upload event), runs)
        pos = 0
        for runs_c in stages:
            cnt = sum(n for _, n in runs_c)
            n_slab = ops.slab_bucket_blocks(cnt)
            uploads = []
            for (_, heads), (_, up, _) in zip(shards, self._streams):
                slab, owner = _host_uint16(
                    (C, n_slab, s.block_size, hs, s.head_dim),
                    self._pinned, zero=False)
                # the pow2 pad tail is masked off by the run lengths, but it
                # is uploaded and streamed through the kernel: zeros, not
                # garbage
                slab[:, cnt:] = 0
                self._gather_host(cpu_blocks[pos:pos + cnt], slab,
                                  None if self.mesh is None else heads)
                uploaded = None
                with self._on(up):
                    dev = owner.to(self.device, non_blocking=self._pinned)
                    if up is not None:
                        uploaded = torch.cuda.Event()
                        uploaded.record(up)
                staging.append(owner)
                uploads.append((dev, uploaded))
                self.h2d_transfers += 1
            pos += cnt
            self.staged_in_calls += 1
            if queued is not None:
                self._scatter(*queued)
            queued = (uploads, runs_c)
        self._scatter(*queued)
        for _, _, sc in self._streams:
            if sc is not None:
                done = torch.cuda.Event()
                done.record(sc)
                done.synchronize()
        staging.clear()

    def _gather_host(self, cpu_blocks: Sequence[int], slab: np.ndarray,
                     heads: Optional[slice] = None) -> None:
        """slab[:, j] = the host pool's block ``cpu_blocks[j]`` in every
        (layer, K/V) plane, or its ``heads`` only (a shard's slab): one
        copy of each block into the staging slab (numpy's
        ``cpu[:, :, ids]`` would gather into a temporary first), with its
        index rules (a negative id counts from the end, one out of range
        raises ``IndexError``)."""
        nc = self.spec.num_cpu_blocks
        ids = np.asarray(cpu_blocks, np.int64)
        if ids.size and (ids.max() >= nc or ids.min() < -nc):
            raise IndexError(f"host block ids {cpu_blocks} out of range "
                             f"for {nc} blocks")
        C = slab.shape[0]
        if heads is not None:
            # numpy's take would copy the strided source whole first;
            # index_select reads only the blocks it takes
            src = torch.from_numpy(self.cpu.view(np.int16)).view(
                (C, nc) + self.cpu.shape[3:])[..., heads, :]
            idx = torch.from_numpy(ids % nc)
            dst = torch.from_numpy(slab.view(np.int16))
            for c in range(C):
                torch.index_select(src[c], 0, idx, out=dst[c, :ids.size])
            return
        src = self.cpu.reshape(C, nc, -1)
        dst = slab.reshape(C, slab.shape[1], -1)
        for c in range(C):
            np.take(src[c], ids, axis=0, out=dst[c, :ids.size], mode="wrap")

    def _scatter(self, uploads, runs: Sequence[Tuple[int, int]]) -> None:
        """One sub-slab's scatter into each shard's pool, on the shard's
        ``scatter`` stream after its upload's event (the slab, made on the
        ``h2d`` stream, is recorded as used there).  Each pool is written
        in place."""
        for (pool, _), (dev, uploaded), (_, _, sc) in zip(
                self._shards(), uploads, self._streams):
            with self._on(sc):
                if sc is not None:
                    sc.wait_event(uploaded)
                    dev.record_stream(sc)
                ops.scatter_swap_runs(pool, dev.view(torch.bfloat16), runs)

    def write_tokens(self, block_ids: List[int], token_offset: int,
                     k, v) -> None:
        """Write per-layer K/V for contiguous tokens into the paged pool,
        in place (reference ``repro/cache/paged.py:234``).  k, v: (L, T,
        Hkv, D), numpy arrays or tensors (``prefill_kv``'s); token_offset
        = index of the first token in the request.

        A block-aligned offset takes the fused path: one write for all
        touched blocks, the partial last block zero-padded (the tail lies
        beyond the context length: masked by attention and overwritten
        by the decode step before it becomes visible).  Any other offset
        writes block by block, up to ``block_size`` tokens each from the
        offset, and raises ``ValueError`` (pool unchanged) where such a
        piece would run past its block's end, as the reference's
        per-block writes do.  A host-side utility (tools, tests, the
        exact-shape oracle): the engine inserts prefill KV on the device
        through the DecodeRunner."""
        if not self.with_data:
            return
        bs = self.spec.block_size
        k = _kv_tensor(k, self.device)
        v = _kv_tensor(v, self.device)
        T = k.shape[1]
        if T == 0:
            return
        if token_offset % bs == 0:
            L, _, H, D = k.shape
            nblk = (T + bs - 1) // bs
            pad = nblk * bs - T
            if pad:
                k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
                v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            b0 = token_offset // bs
            blocks = torch.as_tensor(list(block_ids[b0:b0 + nblk]),
                                     dtype=torch.long, device=self.device)
            kv = torch.stack([k, v], dim=1).reshape(L, 2, nblk, bs, H, D)
            for pool, heads in self._shards():
                pool[:, :, blocks] = kv[..., heads, :]
            return
        pieces = []
        for t0 in range(0, T, bs):
            t1 = min(t0 + bs, T)
            tok = token_offset + t0
            off = tok % bs
            if off + (t1 - t0) > bs:
                raise ValueError(
                    f"tokens [{tok}, {token_offset + t1}) run past the end "
                    f"of block {tok // bs} ({bs} tokens a block)")
            pieces.append((t0, t1, block_ids[tok // bs], off))
        for t0, t1, blk, off in pieces:
            for pool, heads in self._shards():
                pool[:, 0, blk, off:off + (t1 - t0)] = k[:, t0:t1, heads]
                pool[:, 1, blk, off:off + (t1 - t0)] = v[:, t0:t1, heads]

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
        g = unshard([p[:, :, blocks] for p, _ in self._shards()],
                    POOL_HEAD_AXIS)                 # (L, 2, nb, bs, H, D)
        L, _, nb, _, H, D = g.shape
        flat = g.reshape(L, 2, nb * bs, H, D)[:, :, :n_tokens]
        return flat[:, 0], flat[:, 1]
