"""Device-resident decode runner — the real-mode token hot path.

Counterpart of ``repro/core/decode_runner.py``.
The runner keeps the per-step decode state ON the device in fixed,
bucketed shapes:

  * **Shape bucketing** — the block-table width (pages) and the batch
    dimension are rounded up to powers of two with high-water retention,
    so the kernels see O(log) distinct shapes, as the reference compiles
    O(log) variants.
  * **Persistent block tables** — a (B_bucket, pages_bucket) int32 tensor
    lives on the device; each step only the rows whose block lists
    changed are written.  Context lengths and last tokens advance on the
    device inside the step (``active`` mask).
  * **In-place pool** — the step writes each row's new K/V into the pool
    tensor it was given (the reference donates it).
  * **One captured step per bucket** — where the reference jits the step
    once per (batch, pages) bucket, the runner captures it once per
    bucket as a CUDA graph and replays it at every later step of the
    bucket (``_StepGraph``).  The first step at a bucket runs eagerly (a
    real step, which also loads the kernels' libraries and the cuBLAS
    handles the capture needs); the capture follows it.  Every tensor
    the graph reads or writes keeps its address for the bucket's life:
    rows are written into the bucket's tensors in place, and a replay
    over a moved pool raises.  On CPU tensors (the port's interpret
    mode) the same variants replay by running the step body eagerly.
  * **Device-side sampling** — temperature / top-k / top-p sampling is
    fused into the step (``models.paged.sample_tokens``) with a per-row
    (B, 2) tensor of base threefry keys folded from (seed, rid); the step
    folds the position in, so the stream is a pure function of (seed,
    rid, position), as in the reference.  Where the reference keeps an
    all-greedy step argmax-only with a ``lax.cond`` inside one compiled
    variant, a graph cannot branch on a device value: the runner knows on
    the host whether an active row samples, and a bucket gets a second,
    sampled variant, captured the same way at its first sampled step.
    All-greedy steps keep replaying the argmax-only graph.
  * **Deferred host sync** — the next-token tensor is NOT pulled to the
    host at dispatch.  Right after the step a non-blocking copy into a
    pinned host buffer is queued behind it and an event recorded;
    ``flush`` waits on that event at the start of the NEXT decode, after
    the engine's control plane for that iteration has run.  Anyone
    reading ``token_history`` must flush first.

It also owns runner-managed prefill insertion and the chunked prefill
state machine (``prefill_begin / prefill_chunk_compute /
prefill_chunk_insert / prefill_finish / prefill_abort``): prompts run as
pow2-bucketed position-masked chunks whose KV is carried chunk to chunk
on the device and inserted block-aligned into the pool.

Tensor parallelism: with a ``ServingMesh`` the runner holds per-shard
parameter trees (``models/sharding.shard_params``) and steps the
per-shard pools through the same ``paged_decode_step_device``; every shard
runs inside the same per-bucket graph (the shards share one device, so
one capture holds them all), and the chunked prefill runs the sharded
chunk forward over per-shard carries.  The graph count is that of the
one-device runner for the same workload.

Row-occupancy invariant: a row is either *registered* (owned by a live
request, block table = its pages) or *freed* (block table = trash page,
context 0) — freed rows still execute the step, but their output is
discarded and their KV write lands in the reserved trash block.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import gc
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import launches, ops
from repro_torch.launch.mesh import check_one_device
from repro_torch.models import prng
from repro_torch.models.paged import (paged_decode_step_device,
                                      sample_tokens, shardable_heads)
from repro_torch.models.sharding import is_sharded, shard_params
from repro_torch.models.transformer import serving_params


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclass
class DecodeRequestView:
    """What the runner needs to know about one decoding request."""
    rid: int
    block_ids: Sequence[int]       # GPU pages covering context+1 tokens
    token_history: List[int]       # shared list; flush() appends to it
    # per-request (temperature, top_k, top_p); None = runner default
    sampling: Optional[Tuple[float, float, float]] = None


@dataclass
class RunnerStats:
    steps: int = 0
    rebuilds: int = 0              # bucket growth -> full state re-upload
    rows_updated: int = 0          # incremental row writes
    host_syncs: int = 0            # deferred next-token materializations
    prefills: int = 0              # runner-managed prefill insertions
    prefill_chunks: int = 0        # chunked-prefill forward launches
    prefill_tokens: int = 0        # prompt tokens actually forwarded
    prefill_aborts: int = 0        # mid-prefill preemptions
    graphs_captured: int = 0       # argmax-only variants captured
    sampled_graphs: int = 0        # sampled variants captured
    graph_replays: int = 0         # steps replaying their bucket's variant
    eager_steps: int = 0           # steps run eagerly: each variant's first


@dataclass
class _PrefillState:
    """One in-flight (possibly chunked) prefill.  ``k_carry``/``v_carry``
    hold the per-layer K/V computed so far (pow2-bucketed device
    buffers); ``pos`` counts real tokens processed."""
    view: DecodeRequestView
    toks: List[int]                # tokens to process (hist, or hist[:-1])
    emit_first: bool
    pos: int = 0                   # real tokens already processed
    # (L, S_pad, Hkv, D); under a mesh, per-shard lists over local heads
    k_carry: Optional[torch.Tensor] = None
    v_carry: Optional[torch.Tensor] = None
    last_logits: Optional[torch.Tensor] = None  # (V,) at the last real pos
    emitted: bool = False          # first token already appended to hist


# the step's tensors, in ``paged_decode_step_device``'s order after params
# (the pool a per-shard list of tensors under a mesh)
STEP_TENSORS = ("pool", "block_tables", "context_lens", "tokens", "active",
                "keys", "sampling")


def _address(t):
    """A tensor's data address; a per-shard list's, one per shard."""
    return (tuple(p.data_ptr() for p in t) if is_sharded(t)
            else t.data_ptr())


_gc_lock = threading.Lock()
_gc_pauses = [0, False]          # captures running, collector was enabled


@contextlib.contextmanager
def _gc_paused():
    """Keep Python's cyclic garbage collector off while any thread
    captures.  A collection inside a capture can free a dead runner's
    CUDA graphs, and releasing their memory is not permitted while a
    stream captures: the capture is invalidated.  (``torch.cuda.graph``
    collects before each capture for the same reason.)"""
    with _gc_lock:
        if _gc_pauses[0] == 0:
            _gc_pauses[1] = gc.isenabled()
            gc.disable()
        _gc_pauses[0] += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_pauses[0] -= 1
            if _gc_pauses[0] == 0 and _gc_pauses[1]:
                gc.enable()


class _StepGraph:
    """One variant (argmax-only or sampled) of the decode step of one
    (batch, pages) bucket, captured once over the bucket's tensors and
    replayed at every later step of that variant there.

    On CUDA it holds a ``torch.cuda.CUDAGraph`` of the step, the graph's
    static next-token output ``nxt``, and the kernel launches the graph
    holds (``kernels.launches``: each replay adds them to the wrappers'
    counts).  The capture runs no kernel, so live state is untouched.  On
    CPU tensors (the port's interpret mode) there is no graph: a replay
    runs the step body eagerly over the same tensors and copies its
    tokens into ``nxt``.  Either way it keeps the addresses of the tensors
    it was made over, and a replay over a tensor at another address
    raises: the graph would read and write the old one.

    On CUDA the capture runs on ``stream``, the runner's own side stream,
    in thread-local capture mode.  The engine thread captures under the
    engine's pool lock (``serving._real_decode``), so its own swap workers
    issue no CUDA work then; other threads of the process may (the
    front-end steps each replica on a thread of its own).  Thread-local
    mode leaves their launches, synchronisations and allocations legal
    during the capture, and a capture stream of its own keeps them out of
    the graph: a side stream is non-blocking, so work on the default
    stream does not wait on it.  ``torch.cuda.graph`` is not used, since
    it synchronises the whole device and empties the allocator's cache
    before a capture; the cyclic garbage collector is paused instead
    (``_gc_paused``)."""

    def __init__(self, step: Callable, tensors: Tuple[torch.Tensor, ...],
                 stream: Optional[torch.cuda.Stream]):
        self._step = step
        self._ptrs = tuple(_address(t) for t in tensors)
        self.graph = None
        self.launches: collections.Counter = collections.Counter()
        if tensors[STEP_TENSORS.index("tokens")].is_cuda:
            self.graph = torch.cuda.CUDAGraph()
            with launches.capture() as self.launches, _gc_paused(), \
                    torch.cuda.stream(stream):
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.nxt = step(*tensors)
                finally:
                    self.graph.capture_end()
        else:
            self.nxt = torch.empty_like(tensors[STEP_TENSORS.index("tokens")])

    def check(self, tensors: Tuple[torch.Tensor, ...]) -> None:
        """Raise unless every tensor is at the address captured."""
        for name, t, ptr in zip(STEP_TENSORS, tensors, self._ptrs):
            if _address(t) != ptr:
                raise RuntimeError(
                    f"decode step replayed over a {name} at "
                    f"{_address(t)}, captured over {ptr}: the "
                    f"{name} must be written in place for the bucket's life")

    def replay(self, tensors: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """One step over ``tensors`` (those captured); returns ``nxt``."""
        self.check(tensors)
        if self.graph is None:
            self.nxt.copy_(self._step(*tensors))
        else:
            self.graph.replay()
            launches.replayed(self.launches)
        return self.nxt


class DecodeRunner:
    def __init__(self, model_bundle: dict, *, block_size: int,
                 trash_block: int, min_pages_bucket: int = 1,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0, mesh=None):
        self.mb = model_bundle
        self.bs = block_size
        self.trash = trash_block
        self._min_pages = max(1, min_pages_bucket)
        # ``mesh``: a ``ServingMesh`` — the decode and prefill steps then
        # run tensor-parallel over its model shards, with the q/k/v
        # projections and the pool head-sharded (None: one device)
        self._mesh = mesh
        # matmul weights cast to bf16 once (the values the layers' cast
        # at use would give)
        self._params = serving_params(model_bundle["params"])
        if mesh is None:
            self.device = self._params["embed"]["table"].device
        else:
            cfg = model_bundle["cfg"]
            if not shardable_heads(cfg, mesh.n_shards):
                raise ValueError(f"{cfg.name}: {cfg.n_heads} q / "
                                 f"{cfg.n_kv_heads} kv heads do not divide "
                                 f"over {mesh.n_shards} shards")
            check_one_device(mesh)
            self._params = shard_params(self._params, mesh)
            self.device = mesh.shards[0]
        # the runner-wide default row of the per-row (B, 3) [temperature,
        # top_k, top_p] tensor, and the base key the per-row keys fold from
        self._default_sampling = np.asarray(
            [temperature, float(top_k), top_p], np.float32)
        self._base_key = prng.key_words(seed)
        # bucket high-water marks (never shrink)
        self._pages_bucket = 0
        self._batch_bucket = 0
        # host mirrors of device state
        self._rows: Dict[int, int] = {}               # rid -> row
        self._row_blocks: List[Tuple[int, ...]] = []  # what device bt holds
        self._row_ctx: List[int] = []
        self._free: List[int] = []
        # device state
        self._bt = None                               # (B, P) int32
        self._ctx = None                              # (B,) int32
        self._tok = None                              # (B,) int32
        self._keys = None                             # (B, 2) int64 words
        self._active = None                           # (B,) bool
        self._sampling = None                         # (B, 3) f32
        self._active_rows: frozenset = frozenset()
        # rows whose sampling row has temperature > 0 (host mirror)
        self._sampled_rows: set = set()
        # the current bucket's captured variants, keyed by ``sampled``
        # (each captured at its first step)
        self._graphs: Dict[bool, _StepGraph] = {}
        self._steps = {sampled: functools.partial(
            self._step_nxt, self._params, self.mb["cfg"], sampled=sampled)
            for sampled in (False, True)}
        # deferred next-token sync: the rows' histories waiting for the
        # tokens queued into ``_host_nxt`` (pinned on CUDA) behind the
        # last step, and the event recorded after that copy
        self._pending: Optional[list] = None
        self._host_nxt: Optional[torch.Tensor] = None
        self._nxt_ready = (torch.cuda.Event() if self.device.type == "cuda"
                           else None)
        # the side stream this runner captures its step graphs on
        self._capture_stream = (torch.cuda.Stream(self.device)
                                if self.device.type == "cuda" else None)
        # in-flight chunked prefills, keyed by rid
        self._prefills: Dict[int, _PrefillState] = {}
        self.stats = RunnerStats()

    @property
    def batch_bucket(self) -> int:
        """Decode-batch bucket (0 before the first step).  The step always
        executes this many padded rows, so admitting requests up to the
        bucket adds no step cost — the engine's batch-bucket-aware
        admission targets exactly this size."""
        return self._batch_bucket

    def _row_key(self, rid: int, salt: int = 0) -> np.ndarray:
        """Position-independent per-row base key, folded from (seed, rid)
        as the reference's ``_row_key``: the step folds the position in,
        so the sampled stream is a pure function of (seed, rid, position)
        under any preemption order, row re-registration or bucket rebuild.
        ``salt`` separates the prefill first-token draw from the row's
        decode stream.  Returns the (2,) int64 words."""
        k = prng.fold_in_words(self._base_key, rid)
        return np.asarray(prng.fold_in_words(k, salt) if salt else k,
                          np.int64)

    def _row_sampling(self, view: DecodeRequestView) -> np.ndarray:
        """The (3,) f32 [temperature, top_k, top_p] row for ``view``."""
        if view.sampling is None:
            return self._default_sampling
        t, k, p = view.sampling
        return np.asarray([t, float(k), p], np.float32)

    def _mark_sampling(self, row: int, smp: np.ndarray) -> None:
        """Keep the host mirror of which rows sample up to date."""
        if smp[0] > 0.0:
            self._sampled_rows.add(row)
        else:
            self._sampled_rows.discard(row)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return ops.to_device(a, self.device)

    # ------------------------------------------------------------------
    # deferred host sync
    # ------------------------------------------------------------------

    def flush(self) -> None:
        """Materialize the previous step's next tokens into the request
        histories: wait for the copy queued behind the step, then read the
        host buffer."""
        if self._pending is None:
            return
        rows_hist = self._pending
        self._pending = None
        if self._nxt_ready is not None:
            # fslint: disable=FS003(the deferred-sync point: one wait per step for the pinned next-token copy, by design)
            self._nxt_ready.synchronize()
        # fslint: disable=FS003(reads the pinned host buffer the event above guards; no device wait of its own)
        vals = self._host_nxt.numpy()
        self.stats.host_syncs += 1
        for row, hist in rows_hist:
            hist.append(int(vals[row]))

    def _stage_tokens(self, nxt: torch.Tensor, rows_hist: list) -> None:
        """Queue the step's next tokens into the host buffer behind the
        step (before any later step can overwrite ``nxt``) and mark the
        copy's completion with the event ``flush`` waits on."""
        pinned = self._nxt_ready is not None
        self._host_nxt.copy_(nxt, non_blocking=pinned)
        if pinned:
            self._nxt_ready.record()
        self._pending = rows_hist

    # ------------------------------------------------------------------
    # device-state maintenance
    # ------------------------------------------------------------------

    def _rebuild(self, views: List[DecodeRequestView],
                 pages_bucket: int, batch_bucket: int) -> None:
        """Bucket grew: re-upload the whole (small) control state."""
        self._pages_bucket, self._batch_bucket = pages_bucket, batch_bucket
        self.stats.rebuilds += 1
        self._rows = {}
        self._row_blocks = [()] * batch_bucket
        self._row_ctx = [0] * batch_bucket
        bt = np.full((batch_bucket, pages_bucket), self.trash, np.int32)
        ctx = np.zeros((batch_bucket,), np.int32)
        tok = np.zeros((batch_bucket,), np.int32)
        keys = np.zeros((batch_bucket, 2), np.int64)
        act = np.zeros((batch_bucket,), bool)
        smp = np.zeros((batch_bucket, 3), np.float32)
        self._sampled_rows = set()
        for i, v in enumerate(views):
            ids = tuple(v.block_ids)
            self._rows[v.rid] = i
            self._row_blocks[i] = ids
            self._row_ctx[i] = len(v.token_history) - 1
            bt[i, :len(ids)] = ids
            ctx[i] = self._row_ctx[i]
            tok[i] = v.token_history[-1]
            keys[i] = self._row_key(v.rid)
            act[i] = True
            smp[i] = self._row_sampling(v)
            self._mark_sampling(i, smp[i])
        self._free = list(range(len(views), batch_bucket))
        # the new bucket's tensors: new step variants, each captured at
        # its first step
        self._graphs = {}
        self._host_nxt = torch.empty((batch_bucket,), dtype=torch.int32,
                                     pin_memory=self._nxt_ready is not None)
        self._bt = self._dev(bt)
        self._ctx = self._dev(ctx)
        self._tok = self._dev(tok)
        self._keys = self._dev(keys)
        self._active = self._dev(act)
        self._sampling = self._dev(smp)
        self._active_rows = frozenset(range(len(views)))

    def _scatter_rows(self, pending: Dict[int, Tuple[Tuple[int, ...],
                                                     Optional[int],
                                                     Optional[int],
                                                     Optional[np.ndarray],
                                                     Optional[np.ndarray]]]
                      ) -> None:
        """One batched device write for the changed rows.  Entry value is
        (block_ids, ctx, tok, key_words, sampling_row); the trailing four
        are None for rows whose device counters are already right
        (block-table-only write)."""
        if not pending:
            return
        pb = self._pages_bucket
        entries = [(r, ids, c, t, kd, sr)
                   for r, (ids, c, t, kd, sr) in sorted(pending.items())]
        rows = self._dev(np.asarray([e[0] for e in entries], np.int64))
        btrows = np.full((len(entries), pb), self.trash, np.int32)
        for j, (_, ids, _, _, _, _) in enumerate(entries):
            btrows[j, :len(ids)] = ids
        self._bt[rows] = self._dev(btrows)
        full = [(r, c, t, kd, sr)
                for r, _, c, t, kd, sr in entries if c is not None]
        if full:
            frows = self._dev(np.asarray([f[0] for f in full], np.int64))
            self._ctx[frows] = self._dev(
                np.asarray([f[1] for f in full], np.int32))
            self._tok[frows] = self._dev(
                np.asarray([f[2] for f in full], np.int32))
            self._keys[frows] = self._dev(
                np.stack([np.asarray(f[3], np.int64) for f in full]))
            self._sampling[frows] = self._dev(
                np.stack([np.asarray(f[4], np.float32) for f in full]))
            for r, _, _, _, sr in full:
                self._mark_sampling(r, sr)
        self.stats.rows_updated += len(entries)

    def _set_active(self) -> None:
        """Write the active-row mask into the bucket's mask tensor (in
        place: the captured step reads it there)."""
        act = np.zeros((self._batch_bucket,), bool)
        act[list(self._active_rows)] = True
        self._active.copy_(torch.from_numpy(act))

    def _update_rows(self, views: List[DecodeRequestView]) -> None:
        """Incremental path: write only the rows that changed."""
        current = {v.rid for v in views}
        # per-row pending write, keyed by row so a free + immediate
        # re-register of the same row collapses to one write
        pending: Dict[int, Tuple[Tuple[int, ...], Optional[int],
                                 Optional[int], Optional[np.ndarray],
                                 Optional[np.ndarray]]] = {}
        zero_key = np.zeros((2,), np.int64)
        zero_smp = np.zeros((3,), np.float32)
        for rid in [r for r in self._rows if r not in current]:
            row = self._rows.pop(rid)
            self._row_blocks[row] = ()
            self._row_ctx[row] = 0
            self._free.append(row)
            # point at trash, mask off
            pending[row] = ((), 0, 0, zero_key, zero_smp)
        for v in views:
            ids = tuple(v.block_ids)
            row = self._rows.get(v.rid)
            hist_ctx = len(v.token_history) - 1
            if row is None:
                row = self._free.pop()
                self._rows[v.rid] = row
                self._row_blocks[row] = ids
                self._row_ctx[row] = hist_ctx
                pending[row] = (ids, hist_ctx, v.token_history[-1],
                                self._row_key(v.rid),
                                self._row_sampling(v))
            elif self._row_ctx[row] != hist_ctx:
                # context jumped outside the decode loop (a turn-boundary
                # re-admission rewrote prefill KV while the rid stayed in
                # the batch): the device ctx/token are stale
                self._row_blocks[row] = ids
                self._row_ctx[row] = hist_ctx
                pending[row] = (ids, hist_ctx, v.token_history[-1],
                                self._row_key(v.rid),
                                self._row_sampling(v))
            elif ids != self._row_blocks[row]:
                self._row_blocks[row] = ids       # page-boundary growth or
                pending[row] = (ids, None, None, None, None)  # swap-in move
        self._scatter_rows(pending)
        active = frozenset(self._rows[v.rid] for v in views)
        if active != self._active_rows:
            self._active_rows = active
            self._set_active()

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    @staticmethod
    def _step_nxt(params, cfg, *tensors, sampled: bool) -> torch.Tensor:
        """The step over ``tensors`` (``STEP_TENSORS``); its next tokens."""
        return paged_decode_step_device(params, *tensors, cfg=cfg,
                                        sampled=sampled)[0]

    def _step_tensors(self, pool) -> Tuple[torch.Tensor, ...]:
        return (pool, self._bt, self._ctx, self._tok, self._active,
                self._keys, self._sampling)

    def graph_cache_size(self) -> int:
        """(batch, pages) buckets this runner has stepped at (each rebuild
        opens one, and a step follows it), as the reference's
        ``jit_cache_size()`` counts one compiled variant per bucket; a
        bucket's argmax-only and sampled graphs count once.  Buckets only
        grow, so only the newest bucket's graphs are kept."""
        return self.stats.rebuilds

    def decode(self, views: List[DecodeRequestView], pool):
        """Launch one decode step for ``views`` against ``pool``.  The pool
        is written in place and returned (the caller rebinds, as with the
        reference's donated pool); it must stay the same tensor for the
        bucket's life.  The first step at a bucket runs eagerly and then
        captures the bucket's graph; every later step replays it.  A step
        with an active row at temperature > 0 takes the bucket's sampled
        variant, made the same way.  Next tokens stay on the device until
        ``flush()``."""
        if not views:
            raise ValueError("decode() needs at least one request")
        self.flush()
        need_pages = max(len(v.block_ids) for v in views)
        pages_bucket = max(self._pages_bucket,
                           next_pow2(max(need_pages, self._min_pages)))
        batch_bucket = max(self._batch_bucket, next_pow2(len(views)))
        if (pages_bucket != self._pages_bucket
                or batch_bucket != self._batch_bucket):
            self._rebuild(views, pages_bucket, batch_bucket)
        else:
            self._update_rows(views)
        tensors = self._step_tensors(pool)
        sampled = not self._sampled_rows.isdisjoint(self._active_rows)
        graph = self._graphs.get(sampled)
        if graph is None:
            nxt = self._step_nxt(self._params, self.mb["cfg"], *tensors,
                                 sampled=sampled)
            self._graphs[sampled] = _StepGraph(self._steps[sampled], tensors,
                                               self._capture_stream)
            self.stats.eager_steps += 1
            if sampled:
                self.stats.sampled_graphs += 1
            else:
                self.stats.graphs_captured += 1
        else:
            nxt = graph.replay(tensors)
            self.stats.graph_replays += 1
        self._stage_tokens(nxt, [(self._rows[v.rid], v.token_history)
                                 for v in views])
        for v in views:
            self._row_ctx[self._rows[v.rid]] += 1
        self.stats.steps += 1
        return pool

    # ------------------------------------------------------------------
    # runner-managed prefill insertion
    # ------------------------------------------------------------------

    def _register(self, view: DecodeRequestView) -> bool:
        """Write a (re-)admitted request's row state straight into the
        persistent device tables.  Returns False when the current buckets
        can't hold the row — the next decode()'s rebuild picks it up."""
        if self._bt is None:
            return False
        ids = tuple(view.block_ids)
        hist_ctx = len(view.token_history) - 1
        if len(ids) > self._pages_bucket:
            return False
        row = self._rows.get(view.rid)
        if row is None:
            if not self._free:
                return False
            row = self._free.pop()
            self._rows[view.rid] = row
        self._row_blocks[row] = ids
        self._row_ctx[row] = hist_ctx
        self._scatter_rows({row: (ids, hist_ctx, view.token_history[-1],
                                  self._row_key(view.rid),
                                  self._row_sampling(view))})
        return True

    def release(self, rid: int) -> None:
        """Free an aborted request's row immediately: block table back to
        the trash sentinel, context zeroed, row masked off and returned to
        the free list.  Any open chunked-prefill state is dropped too."""
        self._prefills.pop(rid, None)
        row = self._rows.pop(rid, None)
        if row is None:
            return
        self._row_blocks[row] = ()
        self._row_ctx[row] = 0
        self._free.append(row)
        self._scatter_rows({row: ((), 0, 0, np.zeros((2,), np.int64),
                                  np.zeros((3,), np.float32))})
        if row in self._active_rows:
            self._active_rows = self._active_rows - {row}
            self._set_active()

    def invariant_report(self, live_rids) -> List[str]:
        """Row-map validation for the engine sanitizer.  Returns violation
        strings (empty = clean)."""
        v: List[str] = []
        if self._batch_bucket == 0:
            if self._rows or self._free:
                v.append("D1: runner rows exist before first bucket build")
            return v
        reg = set(self._rows.values())
        free = set(self._free)
        if len(self._free) != len(free):
            v.append(f"D1: duplicate rows in free list {self._free}")
        if len(reg) != len(self._rows):
            v.append(f"D1: two rids share a runner row {self._rows}")
        if reg & free:
            v.append(f"D1: rows both registered and free: {reg & free}")
        if reg | free != set(range(self._batch_bucket)):
            v.append(f"D1: rows {reg | free} do not partition bucket "
                     f"{self._batch_bucket}")
        live = set(live_rids)
        for rid, row in self._rows.items():
            if rid not in live:
                v.append(f"D2: runner row {row} registered to dead rid "
                         f"{rid}")
        for row in free:
            if self._row_blocks[row] != () or self._row_ctx[row] != 0:
                v.append(f"D2: freed row {row} still carries blocks="
                         f"{self._row_blocks[row]} ctx={self._row_ctx[row]}")
        for row in self._active_rows:
            if row not in reg:
                v.append(f"D2: active row {row} not registered")
        return v

    # -- chunked prefill state machine ------------------------------------

    def prefill_begin(self, view: DecodeRequestView, *,
                      emit_first: bool, reused_tokens: int = 0,
                      pool=None) -> int:
        """Open a (possibly chunked) prefill for ``view``: KV for the
        view's history (all of it with ``emit_first`` — a fresh turn; all
        but the pending last token on a recompute re-prefill).

        ``reused_tokens`` > 0 with a ``pool``: the first ``reused_tokens``
        positions' KV is already RESIDENT in the pool — the carry is
        seeded from it (``ops.seed_prefill_carry``) and chunking starts at
        the block-aligned floor of ``reused_tokens``.  The caller must
        hold the pool lock.  Returns the token count left TO PROCESS."""
        if self.bs & (self.bs - 1):
            raise ValueError(f"chunked prefill needs a pow2 block size, "
                             f"got {self.bs}")
        self.flush()              # history must be current before reading
        hist = view.token_history
        toks = hist if emit_first else hist[:-1]
        start = 0
        k_c = v_c = None
        if reused_tokens > 0 and pool is not None:
            start = min(reused_tokens - reused_tokens % self.bs,
                        len(toks) - 1)      # always >= 1 token to process
            start = max(start - start % self.bs, 0)
            if start > 0:
                k_c, v_c = ops.seed_prefill_carry(
                    pool, view.block_ids, start, trash=self.trash)
        self._prefills[view.rid] = _PrefillState(
            view=view, toks=list(toks), emit_first=emit_first, pos=start,
            k_carry=k_c, v_carry=v_c)
        return len(toks) - start

    def prefill_pending(self, rid: int) -> int:
        """Tokens the open prefill for ``rid`` has left to process."""
        st = self._prefills[rid]
        return len(st.toks) - st.pos

    def prefill_chunk_compute(self, rid: int, n_tokens: int) -> Optional[Tuple]:
        """Compute KV for the next ``n_tokens`` of the open prefill: one
        bucketed chunk forward attending the carry buffers.  Non-final
        chunks must be block-size multiples so every chunk's pool insert
        stays block-aligned.  Touches NO pool state.  Returns the staged
        (k, v, blocks) for ``prefill_chunk_insert``."""
        st = self._prefills[rid]
        if n_tokens <= 0:
            return None
        bs = self.bs
        if st.pos % bs:
            raise ValueError(f"chunk start {st.pos} not block-aligned "
                             f"(bs={bs})")
        if st.pos + n_tokens > len(st.toks):
            raise ValueError(f"chunk [{st.pos}, {st.pos + n_tokens}) runs "
                             f"past the {len(st.toks)} tokens to process")
        chunk = st.toks[st.pos:st.pos + n_tokens]
        st.last_logits, st.k_carry, st.v_carry, k_c, v_c = \
            ops.prefill_chunk(self._params, chunk, st.k_carry,
                              st.v_carry, st.pos, cfg=self.mb["cfg"],
                              block_size=bs, mesh=self._mesh)
        c_pad = (k_c[0] if self._mesh is not None else k_c).shape[1]
        n_pages = -(-n_tokens // bs)
        blocks = np.full((c_pad // bs,), self.trash, np.int32)
        b0 = st.pos // bs
        blocks[:n_pages] = list(st.view.block_ids)[b0:b0 + n_pages]
        st.pos += n_tokens
        self.stats.prefill_chunks += 1
        self.stats.prefill_tokens += n_tokens
        return k_c, v_c, blocks

    def prefill_chunk_insert(self, rid: int, pool, staged):
        """Scatter one staged chunk into the pool (in place) through the
        block table.  Run under the pool lock; returns the pool."""
        if staged is None:
            return pool
        k, v, blocks = staged
        return ops.insert_prefill(pool, k, v, blocks, self.bs)

    def _prefill_emit(self, st: _PrefillState) -> None:
        """Emit the response's first token from the final chunk's last real
        position: drawn with the row's key salted by 1 at position
        ``len(history)``, as the reference; the argmax at temperature 0."""
        if not st.emit_first or st.emitted:
            return
        hist = st.view.token_history
        smp = self._row_sampling(st.view)
        if smp[0] > 0.0:
            tok = sample_tokens(
                st.last_logits[None, :],
                self._dev(self._row_key(st.view.rid, salt=1)[None, :]),
                self._dev(np.asarray([len(hist)], np.int32)),
                self._dev(smp[None, :]))
        else:
            tok = sample_tokens(st.last_logits[None, :], None, None, None,
                                sampled=False)
        # fslint: disable=FS003(first-token emit must sync, as the reference's; once per prefill, not per step)
        hist.append(int(tok[0]))
        st.emitted = True

    def prefill_finish(self, rid: int) -> None:
        """Close a fully-processed prefill: emit the first token (fresh
        turns), register the row in the persistent device tables, and
        drop the carry buffers."""
        st = self._prefills.pop(rid)
        if st.pos != len(st.toks):
            raise ValueError(f"prefill_finish with {len(st.toks) - st.pos} "
                             "tokens pending")
        self._prefill_emit(st)
        self.stats.prefills += 1
        self._register(st.view)

    def prefill_abort(self, rid: int) -> None:
        """Mid-prefill preemption: drop the carry buffers and the state."""
        if self._prefills.pop(rid, None) is not None:
            self.stats.prefill_aborts += 1

    def prefill_emit_first(self, rid: int) -> None:
        """Emit the open prefill's first token (no-op unless the state was
        opened with ``emit_first`` and hasn't emitted yet)."""
        self._prefill_emit(self._prefills[rid])

    def prefill_insert(self, view: DecodeRequestView, pool, staged):
        """Close a whole-prompt prefill (begin, one chunk, emit): scatter
        the staged KV into the pool and register the row.  Run under the
        pool lock; returns the pool."""
        pool = self.prefill_chunk_insert(view.rid, pool, staged)
        self._prefills.pop(view.rid, None)
        self.stats.prefills += 1
        self._register(view)
        return pool

    def prefill(self, view: DecodeRequestView, pool, *,
                emit_first: bool, reused_tokens: int = 0):
        """A whole-prompt prefill back to back, for single-threaded
        callers (tests, tools): begin (the carry seeded from the pool's
        first ``reused_tokens`` positions), one chunk over the rest, the
        first-token emit, the insert.  The pool is written in place and
        returned."""
        total = self.prefill_begin(view, emit_first=emit_first,
                                   reused_tokens=reused_tokens,
                                   pool=pool if reused_tokens else None)
        staged = self.prefill_chunk_compute(view.rid, total)
        self._prefill_emit(self._prefills[view.rid])
        return self.prefill_insert(view, pool, staged)
