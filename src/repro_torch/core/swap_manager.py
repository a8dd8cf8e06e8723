"""Multithreading Swap Manager — FastSwitch §3.2, Algorithm 1.

Responsibilities:
  * asynchronous swap-in/out dispatch on a worker pool (the paper offloads
    CUDA API dispatch to C++ threads; here workers perform the actual pool
    copies while the *latency* of dispatch+execution is accounted on a
    simulated swap-stream timeline — see DESIGN.md §2.3);
  * adaptive sync/async decision from a recent-swap profiler (Step 4);
  * KV-conflict detection between in-flight swap-ins and newly allocated
    GPU blocks, resolved by fine-grained synchronization (Step 3.1);
  * dispatch-order coherence: after ``sync_every`` queued dispatches a
    fine-grained sync point is inserted so higher-priority copies can enter
    the queue (its small cost is part of the call-stack overhead budget).

The simulated clock makes every latency metric deterministic and
hardware-parameterized while the data plane stays real.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.cache.paged import PagedPools
from repro_torch.io.cost_model import HardwareSpec, dispatch_time_us, exec_time_us


class SimClock:
    def __init__(self):
        self.now_us = 0.0

    def advance(self, dt_us: float) -> None:
        assert dt_us >= -1e-9, dt_us
        self.now_us += max(dt_us, 0.0)

    def advance_to(self, t_us: float) -> None:
        self.now_us = max(self.now_us, t_us)


@dataclass
class SwapTask:
    req_id: int
    direction: str                    # "in" | "out"
    n_ops: int
    n_blocks: int
    bytes_total: int
    issued_at: float
    done_at: float
    gpu_blocks: Set[int] = field(default_factory=set)
    cpu_blocks: Set[int] = field(default_factory=set)
    future: Optional[Future] = None
    synchronous: bool = False
    # failure containment (DESIGN.md §7): the copy closure is retained so
    # retries and the watchdog's synchronous rescue can re-run it
    copy_fn: Optional[object] = None
    retries: int = 0                  # failed attempts absorbed by retry
    failed: Optional[str] = None      # terminal copy error (retries spent)
    stalled_us: float = 0.0           # injected completion-signal delay

    def is_completed(self, now_us: float) -> bool:
        if self.future is not None and not self.future.done():
            return False        # data plane must also be finished
        return now_us >= self.done_at


@dataclass
class SwapRecord:
    """r_info entry (recent swapping information, Algorithm 1)."""
    t_us: float
    direction: str
    n_ops: int
    n_blocks: int
    duration_us: float


class MultithreadingSwapManager:
    def __init__(self, hw: HardwareSpec, pools: Optional[PagedPools] = None,
                 *, async_enabled: bool = True, adaptive: bool = True,
                 n_threads: int = 4, sync_every: int = 16,
                 sync_point_us: float = 5.0, r_info_window: int = 64,
                 sync_stall_frac: float = 0.04,
                 max_copy_retries: int = 2,
                 retry_backoff_us: float = 200.0):
        self.hw = hw
        self.pools = pools
        # Mesh sharding (DESIGN.md §9): under a model-parallel mesh the
        # KV pool is HEAD-sharded, so block ids stay shard-GLOBAL — every
        # shard holds the same block layout over its local heads.  The
        # conflict sets, copy_deps and dispatch ordering below are
        # therefore mesh-invariant; only the data plane fans out (one
        # host transfer per chunk PER SHARD, each 1/n_shards the bytes,
        # over per-shard links — so modelled latency stays
        # mesh-independent and sim/real parity holds by construction).
        self.n_shards = 1 if pools is None else pools.n_shards
        self.async_enabled = async_enabled
        self.adaptive = adaptive
        self.sync_every = sync_every
        self.sync_point_us = sync_point_us
        # adaptive decision: a swap whose predicted stall is below this
        # fraction of one decode iteration is dispatched synchronously
        self.sync_stall_frac = sync_stall_frac
        self._executor = ThreadPoolExecutor(max_workers=n_threads) \
            if pools is not None and pools.with_data else None
        self._pool_lock = threading.Lock()
        # swap-stream timeline (I/O resource occupancy)
        self.stream_free_at = 0.0
        self._dispatches_since_sync = 0
        # queues (Algorithm 1)
        self.ongoing_swap_in: List[SwapTask] = []
        # in-flight async swap-outs: their source GPU blocks must not be
        # overwritten until the d2h copy completes (paper §3.2: conflicts
        # involve "ongoing swapping requests" in BOTH directions)
        self.ongoing_swap_out: List[SwapTask] = []
        self.r_info: List[SwapRecord] = []
        self.r_info_window = r_info_window
        # recent decode-iteration durations (the overlap window an async
        # swap hides in), fed by the engine via note_decode_iter
        self.iter_info: List[float] = []
        # metrics
        self.total_ops = 0
        self.total_blocks = 0
        self.total_bytes = 0
        self.ops_by_dir = {"in": 0, "out": 0}
        self.blocks_by_dir = {"in": 0, "out": 0}
        self.total_stall_us = 0.0          # main-thread (GPU-idle) stall
        self.total_io_us = 0.0             # swap-stream busy time
        self.n_conflicts = 0
        self.n_syncs = 0
        self.callstack_overhead_us = 0.0   # fine-grained sync points etc.
        # failure containment (DESIGN.md §7): copy errors never escape a
        # worker — a copy is retried with backoff (charged to the task's
        # simulated ``done_at``); a task whose retries are spent lands on
        # ``failed_tasks`` for the engine's recovery ladder to process.
        self.max_copy_retries = max_copy_retries
        self.retry_backoff_us = retry_backoff_us
        self._fail_lock = threading.Lock()
        self.failed_tasks: List[SwapTask] = []
        self.retry_log: List[Dict[str, object]] = []   # engine drains ->
        #                                                "retry" events
        self.n_retries = 0
        self.n_copy_failures = 0
        self.n_watchdog = 0

    # ------------------------------------------------------------------
    # cost helpers
    # ------------------------------------------------------------------

    def _op_costs(self, runs: Sequence[Tuple[int, int]], block_bytes: int,
                  h2d: bool) -> Tuple[int, int, int, float, float]:
        """runs: [(start_block, n_blocks)] contiguous transfer ops.
        Returns (n_ops, n_blocks, bytes, dispatch_us, exec_us)."""
        n_ops = len(runs)
        n_blocks = sum(n for _, n in runs)
        total_bytes = n_blocks * block_bytes
        disp = n_ops * dispatch_time_us(self.hw)
        ex = sum(exec_time_us(self.hw, n * block_bytes, h2d) for _, n in runs)
        return n_ops, n_blocks, total_bytes, disp, ex

    def _sync_points(self, n_ops: int) -> float:
        """Dispatch-order coherence: a sync point every ``sync_every`` ops."""
        self._dispatches_since_sync += n_ops
        n_sync = self._dispatches_since_sync // self.sync_every
        self._dispatches_since_sync %= self.sync_every
        cost = n_sync * self.sync_point_us
        self.callstack_overhead_us += cost
        return cost

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------

    def dispatch(self, clock: SimClock, req_id: int, direction: str,
                 runs: Sequence[Tuple[int, int]], block_bytes: int,
                 gpu_blocks: Sequence[int], *, asynchronous: bool,
                 copy_fn=None, copy_deps: Sequence[Future] = (),
                 cpu_blocks: Sequence[int] = (),
                 extra_latency_us: float = 0.0) -> SwapTask:
        """Issue one swap (all ops of one request, one direction).

        ``copy_deps``: data-plane futures that must complete before
        ``copy_fn`` runs (any copy touching CPU blocks a still-queued
        swap-out writes — see ``data_deps``).  Awaited BEFORE the pool
        lock is taken — a dependency's own copy needs that lock, so
        waiting inside it would deadlock.  ``cpu_blocks``: the host
        blocks this task's copy writes (out) or reads (in), tracked so
        later copies can order behind it.

        ``extra_latency_us``: injected completion-signal delay (fault
        injection): extends the task's ``done_at`` but NOT the stream
        timeline — a stuck signal does not occupy the link; the watchdog
        is what rescues it."""
        h2d = direction == "in"
        n_ops, n_blocks, nbytes, disp, ex = self._op_costs(
            runs, block_bytes, h2d)
        sync_cost = self._sync_points(n_ops)
        # capture the issue time BEFORE any synchronous stall advances the
        # clock, or sync tasks would record issued_at == done_at
        issued_at = clock.now_us
        start = max(clock.now_us, self.stream_free_at)
        duration = disp + ex + sync_cost
        done_at = start + duration
        self.stream_free_at = done_at
        self.total_io_us += duration
        done_at += extra_latency_us

        if asynchronous:
            # dispatch happens on a worker thread: main thread not blocked
            stall = 0.0
        else:
            # main thread dispatches AND waits: inference stalls until done
            stall = done_at - clock.now_us
            clock.advance_to(done_at)
        self.total_stall_us += stall

        task = SwapTask(req_id=req_id, direction=direction, n_ops=n_ops,
                        n_blocks=n_blocks, bytes_total=nbytes,
                        issued_at=issued_at, done_at=done_at,
                        gpu_blocks=set(gpu_blocks),
                        cpu_blocks=set(cpu_blocks),
                        synchronous=not asynchronous,
                        copy_fn=copy_fn, stalled_us=extra_latency_us)
        if copy_fn is not None:
            if asynchronous and self._executor is not None \
                    and direction == "out":
                # only d2h gathers run on workers: they READ the pool
                # (forced before return) and never donate.  Pool-MUTATING
                # swap-in copies always run on the dispatching thread so
                # the pool's donation chain (decode, prefill insert,
                # swap-in scatter) stays single-threaded — cross-thread
                # donation of in-flight buffers tears KV (DESIGN.md §4.3).
                task.future = self._executor.submit(
                    self._run_copy_guarded, task, copy_deps)
            else:
                self._run_copy_guarded(task, copy_deps)
                if task.synchronous and task.retries:
                    # inline retries pushed done_at out by the backoff:
                    # the dispatching thread waited that out too
                    extra = max(0.0, task.done_at - clock.now_us)
                    self.total_stall_us += extra
                    clock.advance_to(task.done_at)
        self.total_ops += n_ops
        self.total_blocks += n_blocks
        self.total_bytes += nbytes
        self.ops_by_dir[direction] += n_ops
        self.blocks_by_dir[direction] += n_blocks
        # record at ISSUE time: a synchronous stall has already advanced
        # the clock here, and the adaptive profiler must see issue-time
        # ordering (a sync task would otherwise appear to start at its
        # own completion)
        self.r_info.append(SwapRecord(issued_at, direction, n_ops,
                                      n_blocks, duration))
        if len(self.r_info) > self.r_info_window:
            self.r_info = self.r_info[-self.r_info_window:]
        if asynchronous:
            if direction == "in":
                self.ongoing_swap_in.append(task)
            else:
                self.ongoing_swap_out.append(task)
        return task

    def _locked(self, fn):
        with self._pool_lock:
            return fn()

    def _run_copy_guarded(self, task: SwapTask,
                          deps: Sequence[Future]) -> None:
        """Run one task's data-plane copy with bounded retry.  NEVER
        raises: an exception from a copy must not escape a worker future
        into whatever unrelated request later awaits it (``synchronize``,
        ``data_deps``) — that is the exact failure-amplification this
        layer removes.  Each retry pushes the task's simulated ``done_at``
        out by a linear backoff; spent retries mark the task ``failed``
        and queue it for the engine's recovery ladder."""
        for f in deps:              # data ordering only — no sim-clock cost
            try:
                f.result()
            except BaseException:
                pass                # dep failures are handled by THEIR task
        if task.copy_fn is None:
            return
        attempt = 0
        while True:
            try:
                with self._pool_lock:
                    task.copy_fn()
                return
            except Exception as e:
                attempt += 1
                task.retries = attempt
                with self._fail_lock:
                    self.n_retries += 1
                    self.retry_log.append({
                        "rid": task.req_id, "direction": task.direction,
                        "attempt": attempt,
                        "error": f"{type(e).__name__}: {e}"})
                if attempt > self.max_copy_retries:
                    task.failed = f"{type(e).__name__}: {e}"
                    with self._fail_lock:
                        self.n_copy_failures += 1
                        self.failed_tasks.append(task)
                    return
                task.done_at += self.retry_backoff_us * attempt

    def data_deps(self, cpu_blocks: Sequence[int]) -> List[Future]:
        """Data-plane futures a new copy touching ``cpu_blocks`` must
        order behind: any still-in-flight swap-out WRITING an overlapping
        host block.  Covers a swap-in reading blocks its own queued
        swap-out writes AND a contamination reallocation handing a
        victim's CPU blocks to another request while the victim's d2h is
        still queued (late worker write would clobber the new owner).
        GPU-side ordering is covered by block-conflict syncs — the
        simulated stream serializes *latency*, but worker execution
        order is not FIFO."""
        s = set(cpu_blocks)
        return [t.future for t in self.ongoing_swap_out
                if t.future is not None and t.cpu_blocks & s]

    # ------------------------------------------------------------------
    # Algorithm 1 steps
    # ------------------------------------------------------------------

    def poll_completed(self, clock: SimClock) -> List[SwapTask]:
        """Step 1: move finished swap-ins out of ongoing_swap_in (and prune
        finished swap-outs)."""
        done = [t for t in self.ongoing_swap_in if t.is_completed(clock.now_us)]
        self.ongoing_swap_in = [t for t in self.ongoing_swap_in
                                if not t.is_completed(clock.now_us)]
        self.ongoing_swap_out = [t for t in self.ongoing_swap_out
                                 if not t.is_completed(clock.now_us)]
        return done

    def detect_conflicts(self, gpu_blocks: Sequence[int]) -> List[SwapTask]:
        """Step 3.1: in-flight swaps whose GPU blocks intersect
        ``gpu_blocks`` (about to be written by running requests): swap-in
        targets AND swap-out sources both conflict."""
        s = set(gpu_blocks)
        return [t for t in self.ongoing_swap_in + self.ongoing_swap_out
                if t.gpu_blocks & s]

    def synchronize(self, clock: SimClock, tasks: Optional[List[SwapTask]]
                    = None) -> None:
        """Fine-grained sync: wait for specific tasks (or all)."""
        tasks = self.ongoing_swap_in if tasks is None else tasks
        if not tasks:
            return
        target = max(t.done_at for t in tasks)
        stall = max(0.0, target - clock.now_us)
        self.total_stall_us += stall
        clock.advance_to(target)
        for t in tasks:
            if t.future is not None:
                t.future.result()
        done_ids = {id(t) for t in tasks}
        self.ongoing_swap_in = [t for t in self.ongoing_swap_in
                                if id(t) not in done_ids]
        self.ongoing_swap_out = [t for t in self.ongoing_swap_out
                                 if id(t) not in done_ids]
        self.n_syncs += 1

    def retire_request(self, rid: int) -> int:
        """Abort support: drop an aborted request's in-flight swap-IN
        chunk tasks.  Their data-plane copies already ran inline on the
        dispatching thread (pool-mutating h2d copies never go to workers
        — DESIGN.md §4.3), so only simulated latency is outstanding and
        nothing dangles.  Its swap-OUT tasks are deliberately LEFT on
        ``ongoing_swap_out``: their worker d2h gathers may still be
        writing the request's (now released) CPU blocks, and later
        copies reallocating those blocks order behind the listed futures
        via ``data_deps`` — dropping the task would drop that ordering.
        They retire on completion through ``poll_completed`` as usual.
        Returns the number of swap-in tasks dropped."""
        before = len(self.ongoing_swap_in)
        self.ongoing_swap_in = [t for t in self.ongoing_swap_in
                                if t.req_id != rid]
        return before - len(self.ongoing_swap_in)

    # ------------------------------------------------------------------
    # failure containment (DESIGN.md §7)
    # ------------------------------------------------------------------

    def has_failed(self, rid: int, direction: Optional[str] = None) -> bool:
        """True if an unprocessed copy failure is queued for ``rid``."""
        with self._fail_lock:
            return any(t.req_id == rid
                       and (direction is None or t.direction == direction)
                       for t in self.failed_tasks)

    def take_failed(self) -> List[SwapTask]:
        """Drain the failed-task queue (engine step 0: the recovery
        ladder processes each failure exactly once)."""
        with self._fail_lock:
            out, self.failed_tasks = self.failed_tasks, []
        # a failed task's data never arrived — drop it from the ongoing
        # lists so it neither blocks promotion forever nor orders later
        # copies behind a write that will not happen
        dead = {id(t) for t in out}
        self.ongoing_swap_in = [t for t in self.ongoing_swap_in
                                if id(t) not in dead]
        self.ongoing_swap_out = [t for t in self.ongoing_swap_out
                                 if id(t) not in dead]
        return out

    def take_failed_for(self, rid: int) -> List[SwapTask]:
        """Drain (and de-list) queued copy failures for one request —
        the inline-detection path (``_swap_in`` / prefix restore) and
        request teardown, which must not leave stale failures for a
        later reuse of the handle."""
        with self._fail_lock:
            mine = [t for t in self.failed_tasks if t.req_id == rid]
            self.failed_tasks = [t for t in self.failed_tasks
                                 if t.req_id != rid]
        dead = {id(t) for t in mine}
        self.ongoing_swap_in = [t for t in self.ongoing_swap_in
                                if id(t) not in dead]
        self.ongoing_swap_out = [t for t in self.ongoing_swap_out
                                 if id(t) not in dead]
        return mine

    def drain_retries(self) -> List[Dict[str, object]]:
        """Drain the retry log (engine -> "retry" events)."""
        with self._fail_lock:
            out, self.retry_log = self.retry_log, []
        return out

    def watchdog_check(self, clock: SimClock,
                       watchdog_us: float) -> List[SwapTask]:
        """Escalate stuck in-flight tasks (DESIGN.md §7 ladder step 2):
        a task still incomplete ``watchdog_us`` after issue gets its data
        plane forced synchronously on the engine thread — if its copy had
        already failed terminally, one last synchronous retry runs here —
        and its stuck completion signal clamped to now (+ one sync-point
        charge).  Returns the tasks rescued; a task whose synchronous
        retry also failed stays ``failed`` for ``take_failed``."""
        if watchdog_us <= 0:
            return []
        rescued: List[SwapTask] = []
        for t in list(self.ongoing_swap_in) + list(self.ongoing_swap_out):
            if t.is_completed(clock.now_us) or t.failed is not None:
                continue
            if clock.now_us - t.issued_at < watchdog_us:
                continue
            if t.future is not None:
                t.future.result()       # guarded runner: never raises
            if t.failed is not None:
                # terminal copy failure surfaced while we waited: one
                # synchronous retried copy on the engine thread
                try:
                    with self._pool_lock:
                        if t.copy_fn is not None:
                            t.copy_fn()
                    t.failed = None
                    with self._fail_lock:
                        if t in self.failed_tasks:
                            self.failed_tasks.remove(t)
                except Exception:
                    continue            # stays failed; ladder escalates
            stall = self.sync_point_us
            self.total_stall_us += stall
            self.callstack_overhead_us += stall
            clock.advance(stall)
            t.done_at = min(t.done_at, clock.now_us)
            self.n_watchdog += 1
            rescued.append(t)
        return rescued

    def resolve_conflicts(self, clock: SimClock,
                          gpu_blocks: Sequence[int]) -> int:
        conflicts = self.detect_conflicts(gpu_blocks)
        if conflicts:
            self.n_conflicts += len(conflicts)
            self.synchronize(clock, conflicts)
        return len(conflicts)

    # ------------------------------------------------------------------
    # Step 4: adaptive strategy
    # ------------------------------------------------------------------

    def note_decode_iter(self, duration_us: float) -> None:
        """Feed the adaptive profiler one decode-iteration duration — the
        overlap window an asynchronous swap can hide in."""
        self.iter_info.append(duration_us)
        if len(self.iter_info) > self.r_info_window:
            self.iter_info = self.iter_info[-self.r_info_window:]

    def predicted_stall_us(self, runs: Sequence[Tuple[int, int]],
                           block_bytes: int, h2d: bool,
                           now_us: Optional[float] = None) -> float:
        """What a SYNCHRONOUS dispatch of ``runs`` would stall the main
        thread: queue wait behind in-flight swaps on the stream, plus
        dispatch and execution of every op."""
        _, _, _, disp, ex = self._op_costs(runs, block_bytes, h2d)
        queue = max(0.0, self.stream_free_at - now_us) \
            if now_us is not None else 0.0
        return queue + disp + ex

    def decide_async(self, running_batch: int, pending_swap_blocks: int,
                     *, runs: Optional[Sequence[Tuple[int, int]]] = None,
                     block_bytes: Optional[int] = None, h2d: bool = False,
                     now_us: Optional[float] = None) -> bool:
        """Dynamic swapping decision (paper: async is NOT always best —
        with many short requests the swap is small relative to the tokens
        a sync swap would unblock), driven by the cost model: compare the
        PREDICTED synchronous stall (queue wait + dispatch + execution,
        ``exec_time_us``) against the PREDICTED overlap window (the mean
        of recent decode-iteration durations).  A swap whose stall is a
        negligible fraction of one iteration (``sync_stall_frac``,
        calibrated so the paper's "<8 blocks at batch>=32" region maps to
        ~4% of an A10 iteration) is cheaper done synchronously — no
        conflict-sync risk, no bookkeeping; a larger one pays for the
        overlap.  Larger running batches mean longer iterations, widening
        the sync-preferred region exactly as the paper observes.

        When the caller has no runs/bytes at hand (legacy call sites,
        tests), the per-block transfer cost is estimated from the full
        recent-swap profile (``r_info``, bounded by ``r_info_window`` —
        not a hardcoded sub-window)."""
        if not self.async_enabled:
            return False
        if not self.adaptive:
            return True
        if runs and block_bytes:
            stall = self.predicted_stall_us(runs, block_bytes, h2d, now_us)
        else:
            if not self.r_info:
                return True
            recent = self.r_info            # full profiler window
            per_block = (sum(r.duration_us for r in recent)
                         / max(1, sum(r.n_blocks for r in recent)))
            stall = pending_swap_blocks * per_block
            if now_us is not None:
                stall += max(0.0, self.stream_free_at - now_us)
        if self.iter_info:
            window = sum(self.iter_info) / len(self.iter_info)
        else:
            # no decode history yet: iteration time grows roughly with
            # the batch; scale the fixed overhead as a coarse stand-in
            window = self.hw.iter_overhead_us * max(1.0, running_batch / 8.0)
        return stall > self.sync_stall_frac * window

    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        return {
            "total_ops": self.total_ops,
            "total_blocks": self.total_blocks,
            "total_bytes": self.total_bytes,
            "ops_in": self.ops_by_dir["in"],
            "ops_out": self.ops_by_dir["out"],
            "blocks_in": self.blocks_by_dir["in"],
            "blocks_out": self.blocks_by_dir["out"],
            "total_stall_us": self.total_stall_us,
            "total_io_us": self.total_io_us,
            "n_conflicts": self.n_conflicts,
            "n_syncs": self.n_syncs,
            "ongoing": len(self.ongoing_swap_in),
            "callstack_overhead_us": self.callstack_overhead_us,
            "copy_retries": self.n_retries,
            "copy_failures": self.n_copy_failures,
            "watchdog_rescues": self.n_watchdog,
        }

    def shutdown(self):
        if self._executor is not None:
            self._executor.shutdown(wait=True)
