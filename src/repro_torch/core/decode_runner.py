"""Device-resident decode runner — the real-mode token hot path.

Counterpart of ``repro/core/decode_runner.py`` (single device, greedy).
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
  * **Deferred host sync** — the next-token tensor is NOT pulled to the
    host at dispatch.  ``flush`` copies it at the start of the NEXT decode
    (the one ``.cpu()`` per step), after the engine's control plane for
    that iteration has run.  Anyone reading ``token_history`` must flush
    first.

It also owns runner-managed prefill insertion and the chunked prefill
state machine (``prefill_begin / prefill_chunk_compute /
prefill_chunk_insert / prefill_finish / prefill_abort``): prompts run as
pow2-bucketed position-masked chunks whose KV is carried chunk to chunk
on the device and inserted block-aligned into the pool.

Sampling is greedy in this slice: a runner default or a request with
temperature > 0 raises ``NotImplementedError``.

Row-occupancy invariant: a row is either *registered* (owned by a live
request, block table = its pages) or *freed* (block table = trash page,
context 0) — freed rows still execute the step, but their output is
discarded and their KV write lands in the reserved trash block.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.paged import paged_decode_step_device, sample_tokens
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


@dataclass
class _PrefillState:
    """One in-flight (possibly chunked) prefill.  ``k_carry``/``v_carry``
    hold the per-layer K/V computed so far (pow2-bucketed device
    buffers); ``pos`` counts real tokens processed."""
    view: DecodeRequestView
    toks: List[int]                # tokens to process (hist, or hist[:-1])
    emit_first: bool
    pos: int = 0                   # real tokens already processed
    k_carry: Optional[torch.Tensor] = None     # (L, S_pad, Hkv, D)
    v_carry: Optional[torch.Tensor] = None
    last_logits: Optional[torch.Tensor] = None  # (V,) at the last real pos
    emitted: bool = False          # first token already appended to hist


def _check_greedy(sampling: np.ndarray) -> np.ndarray:
    if sampling[0] > 0.0:
        raise NotImplementedError(
            "sampling with temperature > 0 is not ported yet; the port "
            "decodes greedily")
    return sampling


class DecodeRunner:
    def __init__(self, model_bundle: dict, *, block_size: int,
                 trash_block: int, min_pages_bucket: int = 1,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0):
        self.mb = model_bundle
        self.bs = block_size
        self.trash = trash_block
        self._min_pages = max(1, min_pages_bucket)
        # matmul weights cast to bf16 once (the values the layers' cast
        # at use would give)
        self._params = serving_params(model_bundle["params"])
        self.device = self._params["embed"]["table"].device
        # ``seed`` keys the sampler's streams in the reference; greedy
        # decoding draws nothing, so it is unused until the sampler lands
        self._default_sampling = _check_greedy(np.asarray(
            [temperature, float(top_k), top_p], np.float32))
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
        self._keys = None                             # (B, 2) int32, zeros
        self._active = None                           # (B,) bool
        self._sampling = None                         # (B, 3) f32
        self._active_rows: frozenset = frozenset()
        # deferred next-token sync: ([(row, token_history)], device tensor)
        self._pending: Optional[Tuple[list, torch.Tensor]] = None
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

    def _row_sampling(self, view: DecodeRequestView) -> np.ndarray:
        """The (3,) f32 [temperature, top_k, top_p] row for ``view``."""
        if view.sampling is None:
            return self._default_sampling
        t, k, p = view.sampling
        return _check_greedy(np.asarray([t, float(k), p], np.float32))

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return ops.to_device(a, self.device)

    # ------------------------------------------------------------------
    # deferred host sync
    # ------------------------------------------------------------------

    def flush(self) -> None:
        """Materialize the previous step's next tokens into the request
        histories: one device-to-host copy for the whole batch."""
        if self._pending is None:
            return
        rows_hist, nxt = self._pending
        self._pending = None
        vals = nxt.cpu().numpy()
        self.stats.host_syncs += 1
        for row, hist in rows_hist:
            hist.append(int(vals[row]))

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
        act = np.zeros((batch_bucket,), bool)
        smp = np.zeros((batch_bucket, 3), np.float32)
        for i, v in enumerate(views):
            ids = tuple(v.block_ids)
            self._rows[v.rid] = i
            self._row_blocks[i] = ids
            self._row_ctx[i] = len(v.token_history) - 1
            bt[i, :len(ids)] = ids
            ctx[i] = self._row_ctx[i]
            tok[i] = v.token_history[-1]
            act[i] = True
            smp[i] = self._row_sampling(v)
        self._free = list(range(len(views), batch_bucket))
        self._bt = self._dev(bt)
        self._ctx = self._dev(ctx)
        self._tok = self._dev(tok)
        self._keys = self._dev(np.zeros((batch_bucket, 2), np.int32))
        self._active = self._dev(act)
        self._sampling = self._dev(smp)
        self._active_rows = frozenset(range(len(views)))

    def _scatter_rows(self, pending: Dict[int, Tuple[Tuple[int, ...],
                                                     Optional[int],
                                                     Optional[int],
                                                     Optional[np.ndarray]]]
                      ) -> None:
        """One batched device write for the changed rows.  Entry value is
        (block_ids, ctx, tok, sampling_row); the trailing three are None
        for rows whose device counters are already right (block-table-only
        write)."""
        if not pending:
            return
        pb = self._pages_bucket
        entries = [(r, ids, c, t, sr)
                   for r, (ids, c, t, sr) in sorted(pending.items())]
        rows = self._dev(np.asarray([e[0] for e in entries], np.int64))
        btrows = np.full((len(entries), pb), self.trash, np.int32)
        for j, (_, ids, _, _, _) in enumerate(entries):
            btrows[j, :len(ids)] = ids
        self._bt[rows] = self._dev(btrows)
        full = [(r, c, t, sr) for r, _, c, t, sr in entries if c is not None]
        if full:
            frows = self._dev(np.asarray([f[0] for f in full], np.int64))
            self._ctx[frows] = self._dev(
                np.asarray([f[1] for f in full], np.int32))
            self._tok[frows] = self._dev(
                np.asarray([f[2] for f in full], np.int32))
            self._sampling[frows] = self._dev(
                np.stack([np.asarray(f[3], np.float32) for f in full]))
        self.stats.rows_updated += len(entries)

    def _set_active(self) -> None:
        act = np.zeros((self._batch_bucket,), bool)
        act[list(self._active_rows)] = True
        self._active = self._dev(act)

    def _update_rows(self, views: List[DecodeRequestView]) -> None:
        """Incremental path: write only the rows that changed."""
        current = {v.rid for v in views}
        # per-row pending write, keyed by row so a free + immediate
        # re-register of the same row collapses to one write
        pending: Dict[int, Tuple[Tuple[int, ...], Optional[int],
                                 Optional[int], Optional[np.ndarray]]] = {}
        zero_smp = np.zeros((3,), np.float32)
        for rid in [r for r in self._rows if r not in current]:
            row = self._rows.pop(rid)
            self._row_blocks[row] = ()
            self._row_ctx[row] = 0
            self._free.append(row)
            pending[row] = ((), 0, 0, zero_smp)   # point at trash, mask off
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
                                self._row_sampling(v))
            elif self._row_ctx[row] != hist_ctx:
                # context jumped outside the decode loop (a turn-boundary
                # re-admission rewrote prefill KV while the rid stayed in
                # the batch): the device ctx/token are stale
                self._row_blocks[row] = ids
                self._row_ctx[row] = hist_ctx
                pending[row] = (ids, hist_ctx, v.token_history[-1],
                                self._row_sampling(v))
            elif ids != self._row_blocks[row]:
                self._row_blocks[row] = ids       # page-boundary growth or
                pending[row] = (ids, None, None, None)   # swap-in move
        self._scatter_rows(pending)
        active = frozenset(self._rows[v.rid] for v in views)
        if active != self._active_rows:
            self._active_rows = active
            self._set_active()

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def decode(self, views: List[DecodeRequestView], pool):
        """Launch one decode step for ``views`` against ``pool``.  The pool
        is written in place and returned (the caller rebinds, as with the
        reference's donated pool).  Next tokens stay on the device until
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
        nxt, pool, self._ctx, self._tok = paged_decode_step_device(
            self._params, pool, self._bt, self._ctx, self._tok,
            self._active, self._keys, self._sampling, cfg=self.mb["cfg"])
        self._pending = ([(self._rows[v.rid], v.token_history)
                          for v in views], nxt)
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
        self._scatter_rows({row: ((), 0, 0, np.zeros((3,), np.float32))})
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
                              block_size=bs)
        c_pad = k_c.shape[1]
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
        """Emit the response's first token (greedy) from the final chunk's
        last real position."""
        if not st.emit_first or st.emitted:
            return
        hist = st.view.token_history
        self._row_sampling(st.view)             # refuses temperature > 0
        tok = sample_tokens(st.last_logits[None, :], None, None, None)
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
