"""Open-world serving core — the engine behind FastSwitch's control plane.

``ServingEngine`` is the vLLM-shaped (``LLMEngine.add_request()/step()``)
open-world core: requests ARRIVE at runtime, stream incremental
``RequestOutput`` deltas, can be CANCELLED in any lifecycle state, and
multi-turn follow-ups continue a retained session through the KV-reuse
path — nothing is pre-sorted or preloaded.  The trace-replay driver the
benchmarks use (``FastSwitchEngine``, core/engine.py) is a thin CLIENT
of this API: arrivals and wake-ups live in the driver, not in ``step()``.

Two execution modes share the full control plane:
  * ``sim``  — token bookkeeping only; latency from the hardware cost
               model.  Used for thousand-conversation benchmark traces.
  * ``real`` — a reduced model decodes actual tokens against the paged
               GPU pool through the hand-written paged-attention kernel, and
               swaps move real KV bytes between pools.

Public API (DESIGN.md §6):
  add_request(prompt, sampling, slo=...) -> handle
  step(until_us=None)                    -> List[RequestOutput]
  abort(handle)                          -> bool   (valid in EVERY state)
  continue_session(handle, prompt, ...)  -> handle (KV-reuse follow-up)
  release_session(handle)                          (drop a retained copy)

Per-iteration flow (Algorithm 1 embedded; arrivals are now the caller's
job between steps):
  1. poll completed async swap-ins -> running
  2. drop requests that can never fit the pool (budget safeguard)
  3. priority-trace step; on update: rebalance queues (preempt / swap-in /
     admit) under the GPU block budget
  4. opportunistic admission of waiting requests
  5. prefill newly admitted requests (prefill-with-prefix accounting)
  6. decode one token for the running batch (+ block allocation with
     conflict resolution)
  7. finish turns: retain KV copy per policy; park the session for
     ``continue_session`` (or release it when ``retain_kv`` is unset)
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import (Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np

from repro_torch.cache.paged import PagedPools, PoolSpec
from repro_torch.core.block_group import (DynamicBlockGroupManager,
                                    OutOfBlocksError)
from repro_torch.core.decode_runner import DecodeRequestView, DecodeRunner
from repro_torch.core.faults import (EngineDrainingError, EngineOverloadError,
                               FatalSwapFault, FaultInjector, PoisonError)
from repro_torch.core.invariants import check_engine_invariants
from repro_torch.core.policies import EngineConfig
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.request_api import (RequestEvent, RequestOutput,
                                    RequestSLOStats, SamplingParams,
                                    SLOSpec, jain_index)
from repro_torch.kernels.block_copy import runs_to_indices, split_runs, trim_runs
from repro_torch.core.reuse import KVCacheReuseManager
from repro_torch.core.scheduler import PriorityScheduler, Request, ReqState
from repro_torch.core.swap_manager import MultithreadingSwapManager, SimClock
from repro_torch.data.priority import PriorityTrace
from repro_torch.data.sharegpt import Conversation, Turn
from repro_torch.io.cost_model import IterationCostModel


@dataclass
class EngineMetrics:
    ttfts_us: List[float] = field(default_factory=list)
    tbts_us: List[float] = field(default_factory=list)
    total_tokens: int = 0
    total_time_us: float = 0.0
    iterations: int = 0
    prefills: int = 0
    preemptions: int = 0
    swap_in_count: int = 0
    swap_out_count: int = 0
    ctx_switch_stall_us: float = 0.0
    callstack_wall_s: float = 0.0      # REAL wall time of the control plane
    aborted: int = 0                   # client cancellations
    dropped: int = 0                   # budget-safeguard drops
    # robustness layer (DESIGN.md §7)
    faulted: int = 0                   # request faults (finish_reason=error)
    shed: int = 0                      # overload-shed waiting requests
    rejected: int = 0                  # add_request refusals (overload/drain)
    swap_failure_resumes: int = 0      # permanent swap failure -> recompute
    invariant_checks: int = 0          # sanitizer passes that ran clean
    # cross-request prefix cache (DESIGN.md §10)
    prefix_hits: int = 0               # admissions with a cached prefix
    prefix_misses: int = 0             # admissions probing empty-handed
    prefix_tokens_saved: int = 0       # prompt tokens not recomputed
    prefix_evictions: int = 0          # cached blocks reclaimed by pressure
    # per-turn SLO attainment records (request_api.RequestSLOStats)
    request_stats: List[RequestSLOStats] = field(default_factory=list)
    # (t_end_us, batch, t_iter_us, prefills_in_iter, stall_so_far_us)
    iter_records: List[Tuple[float, int, float, int, float]] = \
        field(default_factory=list)

    def percentile(self, xs: Sequence[float], p: float) -> float:
        if not xs:
            return 0.0
        return float(np.percentile(np.asarray(xs), p))

    def summary(self) -> Dict[str, float]:
        return {
            "p50_ttft_ms": self.percentile(self.ttfts_us, 50) / 1e3,
            "p95_ttft_ms": self.percentile(self.ttfts_us, 95) / 1e3,
            "p99_ttft_ms": self.percentile(self.ttfts_us, 99) / 1e3,
            "p999_ttft_ms": self.percentile(self.ttfts_us, 99.9) / 1e3,
            "p99_tbt_ms": self.percentile(self.tbts_us, 99) / 1e3,
            "p999_tbt_ms": self.percentile(self.tbts_us, 99.9) / 1e3,
            "throughput_tok_s": (self.total_tokens
                                 / max(self.total_time_us / 1e6, 1e-9)),
            "total_tokens": self.total_tokens,
            "iterations": self.iterations,
            "preemptions": self.preemptions,
            "ctx_switch_stall_us": self.ctx_switch_stall_us,
            "callstack_wall_s": self.callstack_wall_s,
            "aborted": self.aborted,
            "dropped": self.dropped,
            "faulted": self.faulted,
            "shed": self.shed,
            "rejected": self.rejected,
            "swap_failure_resumes": self.swap_failure_resumes,
            "invariant_checks": self.invariant_checks,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_rate": (self.prefix_hits
                                / max(self.prefix_hits
                                      + self.prefix_misses, 1)),
            "prefix_tokens_saved": self.prefix_tokens_saved,
            "prefix_evictions": self.prefix_evictions,
        }

    def slo_summary(self) -> Dict[str, Optional[float]]:
        """Per-request SLO-attainment + fairness rollup (DESIGN.md §6.4).

        Tail percentiles hide WHICH users missed; a fairness-aware
        scheduler is judged on attainment per request and its spread.
        ``jain_fairness_tbt`` is Jain's index over per-turn TBT
        attainment fractions (1.0 = every user equally served)."""
        stats = self.request_stats
        ttft = [s.ttft_ok for s in stats if s.ttft_ok is not None]
        tbt_tok = [(s.tbt_ok_frac, max(s.generated - 1, 0))
                   for s in stats if s.tbt_ok_frac is not None]
        attained = [s.attained for s in stats if s.attained is not None]
        tok_total = sum(n for _, n in tbt_tok)
        return {
            "turns": len(stats),
            "ttft_slo_attainment": (sum(ttft) / len(ttft)) if ttft else None,
            "tbt_slo_attainment": (sum(f * n for f, n in tbt_tok)
                                   / tok_total) if tok_total else None,
            "slo_attainment": (sum(attained) / len(attained))
            if attained else None,
            "jain_fairness_tbt": jain_index(
                [s.tbt_ok_frac for s in stats if s.tbt_ok_frac is not None]),
            "aborted": self.aborted,
            "dropped": self.dropped,
        }


class ServingEngine:
    def __init__(self, config: EngineConfig,
                 trace: Optional[PriorityTrace] = None,
                 model_bundle: Optional[dict] = None,
                 event_sink: Optional[Callable[[RequestEvent], None]] = None,
                 keep_events: bool = True,
                 stream_tokens: bool = False):
        self.config = config
        pol = config.policy
        self.clock = SimClock()
        self.metrics = EngineMetrics()

        group_blocks = pol.initial_group_blocks if pol.use_block_groups else 1
        self.gpu_mgr = DynamicBlockGroupManager(
            config.num_gpu_blocks - 1,     # last block reserved as trash
            config.block_size, initial_group_blocks=group_blocks,
            seed=config.seed)
        self.reuse = KVCacheReuseManager(
            config.num_cpu_blocks, config.block_size,
            initial_group_blocks=group_blocks, enabled=pol.use_reuse,
            prealloc_blocks=pol.prealloc_blocks if pol.use_reuse else 0)

        self.model_bundle = model_bundle
        self.pools: Optional[PagedPools] = None
        # real-mode serving mesh: None at (1, 1), the one-device engine;
        # otherwise the decode and prefill steps and the staged swap plane
        # run tensor-parallel over its model shards.  Sim mode has no data
        # plane and ignores ``mesh_shape``, as the reference does.  The
        # bundle's optional ``mesh_devices`` lists the mesh's devices
        # (repeats allowed: shards sharing one device)
        self.mesh = None
        if config.mode == "real":
            assert model_bundle is not None, "real mode needs a model bundle"
            from repro_torch.launch.mesh import make_serving_mesh
            self.mesh = make_serving_mesh(config.mesh_shape,
                                          model_bundle.get("mesh_devices"))
            cfg = model_bundle["cfg"]
            spec = PoolSpec.from_config(cfg, config.num_gpu_blocks,
                                        config.num_cpu_blocks,
                                        config.block_size)
            device = model_bundle["params"]["embed"]["table"].device
            self.pools = PagedPools(spec, with_data=True, device=device,
                                    mesh=self.mesh)
            # a swap-in scattering into freed blocks orders behind the
            # device work issued before they were freed, and only that
            self.gpu_mgr.on_release = self.pools.note_released
            self.block_bytes = spec.block_bytes()
            from repro_torch.models.params import count_params_analytic
            model_params = count_params_analytic(cfg)
            kv_tok = spec.block_bytes() // spec.block_size
        else:
            # sim mode: modelled LLaMA-8B-like footprint
            self.block_bytes = config.kv_bytes_per_token * config.block_size
            model_params = config.model_params
            kv_tok = config.kv_bytes_per_token
        # beyond-paper wire compression (int8 KV on the PCIe/DMA link)
        self.block_bytes = self.block_bytes * pol.swap_wire_bytes_per_elem // 2

        self.swap = MultithreadingSwapManager(
            config.hardware, self.pools,
            async_enabled=pol.use_async_swap,
            adaptive=pol.adaptive_async,
            r_info_window=config.r_info_window,
            max_copy_retries=config.swap_max_retries,
            retry_backoff_us=config.swap_retry_backoff_us)
        self.iter_cost = IterationCostModel(
            config.hardware, model_params=model_params,
            kv_bytes_per_token=kv_tok)

        self.trace = trace or PriorityTrace()
        self.sched = PriorityScheduler(self.trace, config.max_running)
        # live-priority fallback for contamination victims never seen by
        # update_priority (the trace lazily assigns, so this never raises)
        self.reuse.priority_fn = self.sched.priority
        # cross-request prefix cache (DESIGN.md §10): radix tree of shared
        # full-block prompt prefixes pinned on the GPU pool.  Real mode
        # only (sim prompts have no token ids to key on) and requires a
        # reuse-enabled policy: the disabled-reuse swap paths rewrite a
        # request's whole context in place, which would scribble over
        # pinned shared blocks.
        self.prefix: Optional[PrefixCache] = None
        if config.prefix_cache:
            if config.mode != "real":
                raise ValueError("prefix_cache needs mode='real' "
                                 "(sim prompts carry no token ids)")
            if not pol.use_reuse or pol.preemption_mode != "swap":
                raise ValueError("prefix_cache requires a reuse-enabled "
                                 "policy (preemption_mode='swap' with "
                                 "use_reuse)")
            self.prefix = PrefixCache(self.gpu_mgr, config.block_size)
        # retained (FINISHED) sessions awaiting continue_session/release
        self.parked: Dict[int, Request] = {}
        self._next_handle = 0
        self._token_hist_by_conv: Dict[int, List[int]] = {}
        # per-request CPU block-id mirror for the data plane
        self._trash_block = config.num_gpu_blocks - 1
        # batch-bucket-aware admission: iterations the engine has held a
        # boundary against under-pressure growth (bounded, see
        # _admission_target)
        self._bucket_hold = 0
        self._bucket_hold_iter = -1
        # device-resident decode hot path (real mode): persistent block
        # tables, bucketed shapes, donated pool — see DESIGN.md §3
        self.runner: Optional[DecodeRunner] = None
        if self.pools is not None:
            self.runner = DecodeRunner(
                model_bundle, block_size=config.block_size,
                trash_block=self._trash_block,
                temperature=config.temperature, top_k=config.top_k,
                top_p=config.top_p, seed=config.seed, mesh=self.mesh)
        # serving-API surface: step outputs, event log, streaming
        self._outs: Dict[int, RequestOutput] = {}
        self.events: Optional[List[RequestEvent]] = [] if keep_events else None
        self._event_sink = event_sink
        self.stream_tokens = stream_tokens
        # robustness layer (DESIGN.md §7): deterministic fault injection,
        # drain mode, per-(rid, direction) swap dispatch counters (the
        # injector's stable site keys) and the allocation-pressure
        # phantom's current holding
        self.faults = FaultInjector(config.fault_plan)
        self._draining = False
        self._swap_seq: Dict[Tuple[int, str], int] = {}
        self._pressure_blocks = 0

    # ------------------------------------------------------------------
    # public API: request lifecycle
    # ------------------------------------------------------------------

    def add_request(self, prompt: Union[int, Sequence[int]],
                    sampling: Optional[SamplingParams] = None, *,
                    slo: Optional[SLOSpec] = None,
                    handle: Optional[int] = None,
                    retain_kv: bool = False,
                    priority: Optional[float] = None) -> int:
        """Submit one request.  ``prompt`` is the token-id list (real
        mode) or a token COUNT (sim mode — there are no ids to give).
        Returns the request handle, valid for ``step`` outputs,
        ``abort`` and ``continue_session``.

        ``retain_kv``: keep the finished turn's KV as a CPU reuse copy
        so a follow-up ``continue_session`` pays only the prefix swap-in
        instead of a full re-prefill; the caller owns the copy's
        lifetime (``release_session``/``abort`` frees it).

        ``priority``: admission-layer scheduler priority override (the
        front-end maps SLO tightness here, DESIGN.md §11); ``None``
        keeps the engine's priority trace in charge."""
        if self._draining:
            self.metrics.rejected += 1
            raise EngineDrainingError(
                "engine is draining: running requests finish, no new "
                "work is admitted")
        self._check_overload(slo)
        sampling = sampling or SamplingParams()
        self._check_sampling(sampling)
        if handle is None:
            while (self._next_handle in self.sched.requests
                   or self._next_handle in self.parked):
                self._next_handle += 1
            handle = self._next_handle
            self._next_handle += 1
        elif handle in self.sched.requests or handle in self.parked:
            raise ValueError(f"handle {handle} already in use")
        # a reused handle (aborted then re-added between steps) must not
        # inherit the old lifecycle's undelivered output delta
        self._outs.pop(handle, None)
        n_prompt, ids = self._parse_prompt(prompt)
        conv = Conversation(conv_id=handle,
                            arrival_s=self.clock.now_us / 1e6,
                            turns=[Turn(n_prompt, sampling.max_tokens,
                                        prompt_ids=ids)],
                            think_time_s=0.0)
        req = Request(conv=conv)
        req.sampling, req.slo, req.retain_kv = sampling, slo, retain_kv
        req.begin_turn(self.clock.now_us)
        self.sched.add_request(req)
        if priority is not None:
            # before the prefix probe: acquisition pins at this priority
            self.sched.set_priority(handle, priority)
        shared = 0
        if self.prefix is not None and ids is not None:
            # probe the prefix tree BEFORE prefill and pin the matched
            # blocks now — a hit found at arrival must not be evicted
            # while the request waits for admission
            shared = self.prefix.acquire(
                handle, ids, now_us=self.clock.now_us,
                priority=self.sched.priority(handle))
            if shared:
                self.metrics.prefix_hits += 1
                self.metrics.prefix_tokens_saved += shared
            else:
                self.metrics.prefix_misses += 1
        self._event(handle, "arrive", prompt_tokens=n_prompt,
                    max_tokens=sampling.max_tokens,
                    **({"shared_tokens": shared} if shared else {}))
        return handle

    def continue_session(self, handle: int,
                         prompt: Union[int, Sequence[int]],
                         sampling: Optional[SamplingParams] = None, *,
                         slo: Optional[SLOSpec] = None,
                         retain_kv: bool = False,
                         priority: Optional[float] = None) -> int:
        """Follow-up turn on a retained (FINISHED) session: the new
        prompt extends the conversation and admission reuses the CPU KV
        copy of the previous turns (prefix swap-in instead of full
        prefill — the paper's §3.3 mechanism, now exercised open-world)."""
        if self._draining:
            self.metrics.rejected += 1
            raise EngineDrainingError(
                "engine is draining: running requests finish, no new "
                "work is admitted")
        if handle in self.sched.requests:
            raise ValueError(f"handle {handle} still live; a follow-up "
                             "needs the previous turn finished")
        req = self.parked.pop(handle, None)
        if req is None:
            raise KeyError(f"no retained session for handle {handle}")
        sampling = sampling or SamplingParams()
        self._check_sampling(sampling)
        n_prompt, ids = self._parse_prompt(prompt)
        req.conv.turns.append(Turn(n_prompt, sampling.max_tokens,
                                   prompt_ids=ids))
        req.turn_idx += 1
        req.sampling, req.slo, req.retain_kv = sampling, slo, retain_kv
        req.begin_turn(self.clock.now_us)
        self.sched.add_request(req)
        if priority is not None:
            self.sched.set_priority(handle, priority)
        self._event(handle, "continue", turn=req.turn_idx,
                    prompt_tokens=n_prompt, prefix_tokens=req.prefix_tokens)
        return handle

    def release_session(self, handle: int) -> bool:
        """Drop a retained session's CPU KV copy (the caller will not
        follow up).  Live requests are released through ``abort``."""
        req = self.parked.pop(handle, None)
        if req is None:
            return False
        self.reuse.release(handle)
        if self.prefix is not None:
            self.prefix.release(handle)
        req.state = ReqState.DONE
        self.sched.clear_priority(handle)
        self._event(handle, "release")
        return True

    def abort(self, handle: int, reason: str = "abort") -> bool:
        """Cancel a request in ANY lifecycle state — WAITING, RUNNING,
        SWAPPED, SWAPPING_IN, mid-chunked-prefill or FINISHED/retained.
        Releases its GPU blocks and CPU reuse copy, retires its
        in-flight swap-in chunk tasks, drops any open chunked-prefill
        carry, and frees its decode-runner row (block table back to the
        trash sentinel).  In-flight swap-OUT d2h gathers are left on the
        ongoing list so later copies reusing their CPU blocks still
        order behind them (``data_deps``); they retire on completion.
        Returns False for an unknown handle."""
        req = self.sched.requests.get(handle)
        if req is None:
            if handle in self.parked:       # retained session: drop copy
                req = self.parked.pop(handle)
                self.reuse.release(handle)
                if self.prefix is not None:
                    self.prefix.release(handle)
                req.state = ReqState.DONE
                self.sched.clear_priority(handle)
                self.metrics.aborted += 1
                self._event(handle, "abort", state="finished")
                return True
            return False
        state = self._teardown_request(req, reason)
        if reason == "dropped":
            self.metrics.dropped += 1
            self._event(handle, "drop", state=state)
        elif reason == "shed":
            self.metrics.shed += 1
            self._event(handle, "shed", state=state)
        else:
            self.metrics.aborted += 1
            self._event(handle, "abort", state=state)
        return True

    def _teardown_request(self, req, reason: str,
                          error: Optional[str] = None) -> str:
        """The ONE full-resource teardown for a live request — shared by
        client ``abort``, budget drops, overload shedding and the
        request-fault path, so fault cleanup can never drift from abort
        cleanup (every leak class is released in one place): runner row
        + open prefill carry (trash-sentinel rebind), in-flight swap-in
        chunk tasks and queued copy failures, GPU blocks, the CPU reuse
        copy, queue membership, and the terminal output/SLO record.
        In-flight swap-OUT d2h gathers are left on the ongoing list so
        later copies reusing their CPU blocks still order behind them
        (``data_deps``); they retire on completion.  Returns the
        pre-teardown state name (for the caller's event)."""
        handle = req.rid
        state = req.state.value
        if self.runner is not None:
            self.runner.prefill_abort(handle)   # no-op if none open
            self.runner.release(handle)
        req.prefill_remaining = 0
        req.prefill_is_resume = False
        req.resume_tokens = 0
        self.swap.retire_request(handle)
        self.swap.take_failed_for(handle)   # drop stale copy failures
        self.gpu_mgr.release_request(handle)
        self.reuse.release(handle)
        if self.prefix is not None:
            self.prefix.release(handle)     # unpin the shared prefix
        for q in (self.sched.waiting, self.sched.running,
                  self.sched.swapped, self.sched.swapping_in):
            if handle in q:
                q.remove(handle)
        self._record_slo(req, reason)
        out = self._out(handle)
        out.finished, out.finish_reason = True, reason
        if error is not None:
            out.error = error
        out.generated, out.context_tokens = req.generated, req.context_tokens
        req.state = ReqState.DONE
        del self.sched.requests[handle]
        self.sched.clear_priority(handle)
        return state

    def _fault_request(self, rid: int, exc: BaseException) -> None:
        """Containment endpoint: an exception escaping a per-request
        operation faults THAT request — terminal ``finish_reason="error"``
        output, an ``error`` event, full resource teardown — instead of
        crashing ``step()`` and every other live request with it."""
        req = self.sched.requests.get(rid)
        if req is None:
            return
        msg = str(exc)
        if type(exc).__name__ not in msg:
            msg = f"{type(exc).__name__}: {msg}"
        state = self._teardown_request(req, "error", error=msg)
        self.metrics.faulted += 1
        self._event(rid, "error", state=state, error=msg)

    def _contained(self, rid: int, fn, *args, **kwargs):
        """Run one per-request operation with fault isolation: an
        escaping exception faults ``rid`` (terminal error output + full
        teardown) and returns None.  Applied at every step() site whose
        failure is attributable to a single request — batched decode
        stays engine-fatal (its failure has no single owner)."""
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            self._fault_request(rid, e)
            return None

    def has_work(self) -> bool:
        """True while any request is live (retained sessions idle in
        ``parked`` don't count — they cost CPU blocks, not steps)."""
        return bool(self.sched.requests)

    # ------------------------------------------------------------------
    # overload protection / drain (DESIGN.md §7)
    # ------------------------------------------------------------------

    def drain(self) -> None:
        """Enter drain mode: running/queued requests finish normally but
        ``add_request``/``continue_session`` refuse new work — the
        front-end's graceful-shutdown primitive.  Irreversible for the
        engine's lifetime (restart to serve again)."""
        if not self._draining:
            self._draining = True
            self._event(-1, "drain", enabled=True)

    @property
    def draining(self) -> bool:
        return self._draining

    def predicted_ttft_us(self, queue_pos: int) -> float:
        """Coarse admission-queue model: a request entering at waiting
        position ``queue_pos`` waits roughly one mean turn duration per
        ``max_running`` requests ahead of it (turns drain in running-slot
        waves).  Mean turn duration comes from the recent SLO records;
        before any history a prefill-cost floor stands in.  Deliberately
        cheap and pessimism-biased — it gates shedding decisions, not
        billing."""
        stats = self.metrics.request_stats[-32:]
        durs = [s.ttft_us + s.generated * s.mean_tbt_us for s in stats
                if s.ttft_us is not None]
        mean_turn = (sum(durs) / len(durs)) if durs \
            else self.iter_cost.prefill_us(512)
        lanes = max(1, self.config.max_running)
        return (queue_pos // lanes + 1) * mean_turn

    def _doomed_waiting(self) -> set:
        """Waiting requests already predicted to miss their TTFT SLO
        (elapsed wait + predicted remaining queue delay > deadline):
        the shed policy's first victims — serving them spends GPU time
        on responses the client has already timed out on."""
        doomed = set()
        now = self.clock.now_us
        for pos, rid in enumerate(self.sched.waiting):
            req = self.sched.requests[rid]
            slo = req.slo
            if slo is None or slo.ttft_us is None:
                continue
            waited = now - req.turn_arrival_us
            if waited + self.predicted_ttft_us(pos) > slo.ttft_us:
                doomed.add(rid)
        return doomed

    def _check_overload(self, slo: Optional[SLOSpec]) -> None:
        """Bounded waiting queue (``EngineConfig.max_waiting``): policy
        "reject" raises a structured ``EngineOverloadError`` (front-ends
        map it to 429 + retry hint); policy "shed" aborts the least
        valuable waiting request — SLO-doomed first, then lowest
        priority, then newest — to make room for the arrival."""
        mw = self.config.max_waiting
        if mw <= 0 or len(self.sched.waiting) < mw:
            return
        depth = len(self.sched.waiting)
        if self.config.overload_policy == "shed":
            order = self.sched.shed_order(self._doomed_waiting())
            if order:
                self.abort(order[0], reason="shed")
                return
        self.metrics.rejected += 1
        raise EngineOverloadError(
            f"waiting queue full ({depth} >= max_waiting={mw})",
            queue_depth=depth, max_waiting=mw,
            predicted_ttft_us=self.predicted_ttft_us(depth))

    # ------------------------------------------------------------------
    # front-end introspection + session migration (DESIGN.md §11)
    # ------------------------------------------------------------------

    def load_snapshot(self) -> Dict[str, object]:
        """One coherent load sample for router dispatch decisions: queue
        depths, free pool space and the admission-queue TTFT prediction
        a request arriving NOW would face.  Cheap (no device sync) — the
        replica thread publishes one per step."""
        depth = len(self.sched.waiting)
        return {
            "now_us": self.clock.now_us,
            "waiting": depth,
            "running": len(self.sched.running),
            "swapped": len(self.sched.swapped),
            "swapping_in": len(self.sched.swapping_in),
            "parked": tuple(self.parked),
            "free_gpu_blocks": self.gpu_mgr.free_blocks(),
            "max_waiting": self.config.max_waiting,
            "draining": self._draining,
            "predicted_ttft_us": self.predicted_ttft_us(depth),
        }

    def export_session(self, handle: int) -> Dict[str, object]:
        """Package a PARKED session for migration to another replica:
        the conversation turns, token history and the CPU reuse copy's
        KV bytes, then release every local resource (``migrate_out``).
        Only parked sessions migrate — a live request's KV is on GPU and
        mid-flight; the router rebalances between turns.

        A session holding a pinned shared prefix exports with
        ``valid_tokens = 0``: its CPU blocks below the prefix-cache
        floor are phantoms (allocated, never written — see
        ``record_swap_out``), so the bytes aren't shippable and the
        target replica re-prefills the turn instead (its own prefix
        cache may well absorb the cost)."""
        req = self.parked.get(handle)
        if req is None:
            raise KeyError(f"no retained session for handle {handle} "
                           "(only parked sessions migrate)")
        meta = self.reuse.export_copy(handle)
        valid = min(meta["valid_tokens"], req.context_tokens) \
            if meta is not None else 0
        if self._shared_tokens(handle) > 0:
            valid = 0
        kv = None
        if valid > 0 and self.pools is not None:
            bs = self.config.block_size
            nblk = (valid + bs - 1) // bs
            ids = np.asarray(meta["block_ids"][:nblk])
            # the park-time d2h gather runs on a swap-manager worker
            # (async swap-out) — order this read behind any in-flight
            # write to the exported blocks, exactly like a local swap-in
            # does via data_deps, or the export ships unlanded bytes.
            # Waits happen OUTSIDE the pool lock: the dep's own copy
            # needs it.  A failed gather queues a copy failure for the
            # handle; those bytes never arrived, so export the session
            # without KV and let the target re-prefill.
            for f in self.swap.data_deps(list(ids)):
                try:
                    f.result()
                except BaseException:
                    pass
            if self.swap.has_failed(handle, "out"):
                self.swap.take_failed_for(handle)
                valid = 0
            else:
                kv = self.pools.cpu[:, :, ids].copy()
        payload = {
            "handle": handle,
            "turns": [(t.prompt_tokens, t.response_tokens,
                       list(t.prompt_ids) if t.prompt_ids is not None
                       else None) for t in req.conv.turns],
            "turn_idx": req.turn_idx,
            "think_time_s": req.conv.think_time_s,
            "context_tokens": req.context_tokens,
            "token_history": list(req.token_history),
            "valid_tokens": valid,
            "kv": kv,
            "priority": self.sched.extern.get(handle),
        }
        self.parked.pop(handle)
        self.reuse.release(handle)
        if self.prefix is not None:
            self.prefix.release(handle)
        self.sched.clear_priority(handle)
        req.state = ReqState.DONE
        self._event(handle, "migrate_out", valid_tokens=valid,
                    context_tokens=payload["context_tokens"])
        return payload

    def import_session(self, payload: Dict[str, object]) -> int:
        """Install a migrated session as a parked (FINISHED) request:
        rebuild the conversation, write the shipped KV bytes into a
        freshly allocated CPU reuse copy and park the handle
        (``migrate_in``) — the next ``continue_session`` admits through
        the ordinary prefix-swap-in path, bit-exact with a session that
        never moved.  The reuse pool may grant less space than shipped
        (contamination of lower-priority copies only goes so far): the
        advertised prefix is trimmed to what was actually installed, and
        a granted-but-unwritable copy is voided rather than advertised."""
        if self._draining:
            self.metrics.rejected += 1
            raise EngineDrainingError(
                "engine is draining: running requests finish, no new "
                "work is admitted")
        handle = int(payload["handle"])
        if handle in self.sched.requests or handle in self.parked:
            raise ValueError(f"handle {handle} already in use")
        turns = [Turn(pt, rt, prompt_ids=(list(ids) if ids is not None
                                          else None))
                 for pt, rt, ids in payload["turns"]]
        conv = Conversation(conv_id=handle,
                            arrival_s=self.clock.now_us / 1e6,
                            turns=turns,
                            think_time_s=payload["think_time_s"])
        req = Request(conv=conv, turn_idx=int(payload["turn_idx"]))
        req.context_tokens = int(payload["context_tokens"])
        req.token_history = list(payload["token_history"])
        req.hist_emitted = len(req.token_history)
        req.retain_kv = True
        req.state = ReqState.FINISHED
        prio = payload.get("priority")
        if prio is not None:
            self.sched.set_priority(handle, prio)
        valid = int(payload["valid_tokens"])
        cpu_ids = self.reuse.import_copy(
            handle, valid, priority=self.sched.priority(handle))
        got = self.reuse.valid_tokens(handle)
        kv = payload.get("kv")
        if got > 0:
            if kv is None:
                # bytes didn't ship (sim mode has none to ship; real
                # mode always pairs valid>0 with kv) — a real-mode copy
                # without its bytes must not be advertised
                if self.pools is not None:
                    self.reuse.invalidate(handle)
            elif self.pools is not None:
                bs = self.config.block_size
                nblk = (got + bs - 1) // bs
                self.pools.cpu[:, :, np.asarray(cpu_ids[:nblk])] = \
                    kv[:, :, :nblk]
        self.parked[handle] = req
        self._event(handle, "migrate_in",
                    valid_tokens=self.reuse.valid_tokens(handle),
                    context_tokens=req.context_tokens)
        return handle

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _parse_prompt(self, prompt: Union[int, Sequence[int]]
                      ) -> Tuple[int, Optional[List[int]]]:
        if isinstance(prompt, (int, np.integer)):
            if self.pools is not None:
                raise ValueError("real mode needs prompt token ids, "
                                 "not a token count")
            if prompt <= 0:
                raise ValueError(f"empty prompt ({prompt} tokens)")
            return int(prompt), None
        ids = [int(t) for t in prompt]
        if not ids:
            raise ValueError("empty prompt")
        return len(ids), ids

    def _check_sampling(self, sp: SamplingParams) -> None:
        if sp.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {sp.max_tokens}")
        # per-request overrides ride the runner's per-row (B, 3) sampling
        # array (DESIGN.md §3.6) — validate ranges only
        if sp.temperature is not None and sp.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{sp.temperature}")
        if sp.top_k is not None and sp.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {sp.top_k}")
        if sp.top_p is not None and not 0.0 < sp.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {sp.top_p}")

    def _hit_stop(self, req: Request) -> bool:
        """The turn's LAST generated token is one of the request's stop
        ids.  Real mode only (sim prompts/responses carry no token ids);
        ``generated`` guards the prompt's own last token from matching
        before anything was decoded.  Callers must have flushed the
        runner — deferred-sync decode ids land in ``token_history`` only
        on flush."""
        sp = req.sampling
        if (self.pools is None or sp is None or not sp.stop_token_ids
                or req.generated == 0 or not req.token_history):
            return False
        return req.token_history[-1] in sp.stop_token_ids

    def _apply_stop_tokens(self) -> None:
        """Finish running requests whose previous decode produced a stop
        token (``finish_reason="stop"``).  Runs at the top of the decode
        step, BEFORE this iteration's batch is assembled: the stop
        token's KV slot is the turn's last and stays unwritten — exactly
        the pending-token invariant ``_swap_out`` already handles — and
        the request must not decode past it.  The one runner flush is
        shared by every candidate (each flush is a host sync)."""
        cands = [r for r in self.sched.running
                 if (req := self._req(r)).prefill_remaining == 0
                 and req.generated > 0 and req.sampling is not None
                 and req.sampling.stop_token_ids]
        if not cands:
            return
        self.runner.flush()      # histories current before inspection
        for rid in cands:
            if self._hit_stop(self._req(rid)):
                self._contained(rid, self._finish_turn, rid, "stop")

    def _view_sampling(self, req: Request
                       ) -> Optional[Tuple[float, float, float]]:
        """The resolved (temperature, top_k, top_p) row for a request's
        DecodeRequestView: None when the request carries no overrides
        (the runner's engine-default row applies); otherwise each None
        field inherits the engine default."""
        sp = req.sampling
        if (sp is None or (sp.temperature is None and sp.top_k is None
                           and sp.top_p is None)):
            return None
        cfg = self.config
        return (cfg.temperature if sp.temperature is None else sp.temperature,
                cfg.top_k if sp.top_k is None else sp.top_k,
                cfg.top_p if sp.top_p is None else sp.top_p)

    def _budget_tokens(self) -> int:
        return self.gpu_mgr.num_blocks * self.config.block_size

    def _req(self, rid: int) -> Request:
        return self.sched.requests[rid]

    def _out(self, rid: int) -> RequestOutput:
        out = self._outs.get(rid)
        if out is None:
            req = self.sched.requests.get(rid)
            out = RequestOutput(handle=rid,
                                turn=req.turn_idx if req is not None else 0)
            self._outs[rid] = out
        # t_us = the LAST transition's clock instant, stamped as it
        # happens: a later request's synchronous swap stall in the same
        # iteration must not bleed into this one's timestamp (clients
        # schedule think-time wake-ups off the finish instant — replay
        # parity depends on it)
        out.t_us = self.clock.now_us
        return out

    def _credit(self, rid: int, first: bool = False) -> None:
        """Fold one emitted token into this step's output delta."""
        req = self._req(rid)
        out = self._out(rid)
        out.new_tokens += 1
        out.generated = req.generated
        out.context_tokens = req.context_tokens
        if first:
            out.first_token = True
            out.ttft_us = req.ttfts_us[-1]

    def _event(self, rid: int, kind: str, **data) -> None:
        ev = RequestEvent(t_us=self.clock.now_us, handle=rid, kind=kind,
                          data=data)
        if self._event_sink is not None:
            self._event_sink(ev)
        if self.events is not None:
            self.events.append(ev)

    def _record_slo(self, req: Request, reason: str) -> None:
        """Fold the turn's latency record into the per-request SLO
        attainment stats (on finish, abort or drop)."""
        turn = req.current_turn()
        ttft = (req.first_token_us - req.turn_arrival_us) \
            if req.first_token_us is not None else None
        tbts = req.tbts_us[req.tbt_mark:]
        slo = req.slo
        ttft_ok = tbt_frac = None
        if slo is not None:
            if slo.ttft_us is not None and ttft is not None:
                ttft_ok = ttft <= slo.ttft_us
            if slo.tbt_us is not None and tbts:
                tbt_frac = sum(t <= slo.tbt_us for t in tbts) / len(tbts)
        self.metrics.request_stats.append(RequestSLOStats(
            handle=req.rid, turn=req.turn_idx,
            prompt_tokens=turn.prompt_tokens, generated=req.generated,
            ttft_us=ttft,
            mean_tbt_us=(sum(tbts) / len(tbts)) if tbts else 0.0,
            max_tbt_us=max(tbts) if tbts else 0.0,
            ttft_ok=ttft_ok, tbt_ok_frac=tbt_frac, finish_reason=reason))

    def _transfer_runs(self, runs: List[Tuple[int, int]]
                       ) -> List[Tuple[int, int]]:
        """The vLLM baseline issues ONE memcpy per block regardless of
        physical adjacency (Fig. 3a); block-group policies transfer whole
        contiguous runs (Fig. 3b); the Llumnix baseline merges per-block
        copies through a small staging buffer (bounded granularity, one
        transfer per buffer-full — paper §2.2)."""
        pol = self.config.policy
        if pol.use_block_groups:
            return runs
        blocks = runs_to_indices(runs)
        mb = max(1, pol.merge_buffer_blocks)
        if mb == 1:
            return [(b, 1) for b in blocks]
        # staging-buffer merge: one op per <=mb blocks (the buffer copy
        # itself runs at HBM speed — negligible next to the PCIe leg)
        return [(blocks[i], min(mb, len(blocks) - i))
                for i in range(0, len(blocks), mb)]

    def _shared_tokens(self, rid: int) -> int:
        """Block-aligned prefix-cache prefix pinned on GPU for ``rid``."""
        return self.prefix.shared_tokens(rid) if self.prefix is not None \
            else 0

    def _block_table(self, rid: int) -> List[int]:
        """Composed logical->physical block table: the mapped shared
        prefix (prefix-cache nodes) followed by the request's private
        blocks.  Without a mapping this is exactly the manager's table."""
        ids = self.gpu_mgr.request_block_ids(rid)
        if self.prefix is not None:
            shared = self.prefix.blocks_for(rid)
            if shared:
                return shared + ids
        return ids

    def _gpu_alloc_tokens(self, rid: int, n_tokens: int) -> None:
        """allocate+note with prefix-cache eviction fallback: when the
        pool is exhausted, reclaim unreferenced cached leaves (worst
        fairness score first) before the caller falls back to preempting
        a live victim.  Raises OutOfBlocksError when neither helps."""
        if n_tokens <= 0:
            return
        try:
            self.gpu_mgr.allocate_tokens(rid, n_tokens)
        except OutOfBlocksError:
            if self.prefix is None:
                raise
            bs = self.config.block_size
            freed = self.prefix.evict((n_tokens + bs - 1) // bs + 1,
                                      now_us=self.clock.now_us)
            self.metrics.prefix_evictions += freed
            if not freed:
                raise
            self.gpu_mgr.allocate_tokens(rid, n_tokens)
        self.gpu_mgr.note_tokens(rid, n_tokens)

    def _runs_for_tokens(self, rid: int, t0: int, t1: int
                         ) -> List[Tuple[int, int]]:
        """Contiguous GPU block runs covering tokens [t0, t1) of the
        COMPOSED table (shared prefix + private suffix) — swap callers
        only ever pass ranges at or beyond the shared prefix, so the
        resulting runs never contain a pinned shared block."""
        if t1 <= t0:
            return []
        bs = self.config.block_size
        ids = self._block_table(rid)
        b0, b1 = t0 // bs, (t1 + bs - 1) // bs
        blocks = ids[b0:b1]
        runs: List[Tuple[int, int]] = []
        for b in blocks:
            if runs and runs[-1][0] + runs[-1][1] == b:
                runs[-1] = (runs[-1][0], runs[-1][1] + 1)
            else:
                runs.append((b, 1))
        return runs

    # ------------------------------------------------------------------
    # swap operations
    # ------------------------------------------------------------------

    def _swap_out(self, rid: int, keep_copy: bool,
                  last_slot_written: bool = False) -> None:
        """Preempt: move KV to CPU.  With reuse, only the increment beyond
        the valid CPU copy is transferred.  In recompute mode the KV is
        simply dropped (resumption re-prefills the whole context)."""
        req = self._req(rid)
        if self.config.policy.preemption_mode == "recompute":
            self.gpu_mgr.release_request(rid)
            req.resume_tokens = req.context_tokens
            req.prefill_remaining = 0
            req.prefill_is_resume = False
            self.metrics.preemptions += 1
            return
        # Only context_tokens - 1 positions hold written KV: the last
        # slot's K/V is produced by the NEXT decode step (which consumes
        # the pending token as input).  Claiming it would freeze garbage
        # into the CPU copy — once the reuse increment pointer moves past
        # that slot it is never re-copied, and a later swap-in would
        # restore the garbage into attended positions (token corruption
        # whenever a preemption lands on a block-aligned context).  The
        # now-valid slot is picked up by the NEXT increment instead.
        # ``last_slot_written``: a mid-prefill abort has NO pending decode
        # token — every context_tokens position holds chunk-inserted KV,
        # so the whole processed prefix is claimable.
        total = req.context_tokens if last_slot_written \
            else max(req.context_tokens - 1, 0)
        self.reuse.update_priority(rid, self.sched.priority(rid))
        # shared prefix-cache blocks are PINNED on GPU: they are never
        # transferred (floor_tokens excludes [0, shared) from the
        # increment) and never released below — only the private suffix
        # swaps, so preempting one sharer can't tear another's prefix
        shared = self._shared_tokens(rid)
        inc, _cpu_runs = self.reuse.record_swap_out(
            rid, total, requesting_priority=self.sched.priority(rid),
            floor_tokens=shared)
        valid_before = total - inc
        gpu_runs = self._runs_for_tokens(rid, valid_before, total)
        gpu_blocks = runs_to_indices(gpu_runs)
        if gpu_runs:
            # conflicts: blocks we're about to read may be swap-in targets
            self.swap.resolve_conflicts(self.clock, gpu_blocks)
            bs = self.config.block_size
            cpu_ids = self.reuse.mgr.request_block_ids(rid)[
                valid_before // bs:(total + bs - 1) // bs] \
                if self.pools is not None else []
            asynchronous = self.swap.decide_async(
                len(self.sched.running), sum(n for _, n in gpu_runs),
                runs=self._transfer_runs(gpu_runs),
                block_bytes=self.block_bytes, h2d=False,
                now_us=self.clock.now_us)
            self._dispatch_swap(rid, "out", gpu_runs, cpu_ids, asynchronous)
            self.metrics.swap_out_count += 1
        self.gpu_mgr.release_request(rid)
        self.metrics.preemptions += 1

    def _swap_in(self, rid: int) -> bool:
        """Bring a swapped request's KV back to GPU.  Returns True if the
        request is immediately RUNNING (sync), False if in flight."""
        req = self._req(rid)
        tokens = req.context_tokens
        # the shared prefix never left the GPU (pinned) — only the
        # private suffix beyond it is allocated and restored
        shared = self._shared_tokens(rid)
        try:
            self._gpu_alloc_tokens(rid, tokens - shared)
        except OutOfBlocksError:
            # roll back the PARTIAL allocation (allocate_tokens acquires
            # groups incrementally) or the blocks leak into a deadlock
            self.gpu_mgr.release_request(rid)
            return False                     # stays swapped; retry later
        # TOKEN-ordered runs (not request_runs, which sorts by physical
        # start): the data plane pairs these positionally with the
        # token-ordered CPU block list, and a fragmented allocation can
        # hand out groups with descending starts — sorted runs would
        # restore every block into the wrong slot of the block table
        gpu_runs = self._runs_for_tokens(rid, shared, tokens)
        gpu_blocks = runs_to_indices(gpu_runs)
        # the newly allocated target blocks may still be the SOURCE of an
        # in-flight swap-out — synchronize before overwriting them
        self.swap.resolve_conflicts(self.clock, gpu_blocks)
        self.reuse.record_swap_in(rid)
        bs = self.config.block_size
        nblk = (tokens + bs - 1) // bs
        cpu_ids = self.reuse.mgr.request_block_ids(rid)[shared // bs:nblk] \
            if self.pools is not None else []
        asynchronous = self.swap.decide_async(
            len(self.sched.running), sum(n for _, n in gpu_runs),
            runs=self._transfer_runs(gpu_runs),
            block_bytes=self.block_bytes, h2d=True, now_us=self.clock.now_us)
        self._dispatch_swap(rid, "in", gpu_runs, cpu_ids, asynchronous)
        self.metrics.swap_in_count += 1
        self._event(rid, "swap_in", asynchronous=asynchronous,
                    tokens=tokens)
        # Swap-in copies always run INLINE on the dispatching thread
        # (pool-mutating h2d never goes to workers — DESIGN.md §4.3), so
        # a terminal copy failure is known right here, before the request
        # is promoted onto KV that never arrived.
        if self.swap.has_failed(rid, "in"):
            self._recover_swap_in_failure(rid)
            return False
        if asynchronous:
            self.sched.move(rid, ReqState.SWAPPING_IN)
            return False
        self.sched.move(rid, ReqState.RUNNING)
        return True

    def _recover_swap_in_failure(self, rid: int) -> None:
        """Escalation ladder for a swap-in whose copy retries are spent
        (DESIGN.md §7): the GPU-side KV is incomplete and must not be
        decoded against.  Recoverable failures degrade to a
        RECOMPUTE-mode resume — GPU blocks dropped, the request re-enters
        WAITING with ``resume_tokens`` covering its full context, and
        ``_admit_resume`` regenerates the KV from the token history (the
        CPU copy stays valid; nothing corrupted it).  A fatal failure
        ends in a request fault."""
        tasks = self.swap.take_failed_for(rid)
        self.swap.retire_request(rid)    # drop remaining in-flight chunks
        req = self.sched.requests.get(rid)
        if req is None:
            return
        fatal = any(t.failed is not None and "Fatal" in t.failed
                    for t in tasks)
        if fatal:
            err = next(t.failed for t in tasks if t.failed is not None)
            self._fault_request(rid, FatalSwapFault(err))
            return
        self.gpu_mgr.release_request(rid)
        req.resume_tokens = req.context_tokens
        req.prefill_remaining = 0
        req.prefill_is_resume = False
        self.metrics.swap_failure_resumes += 1
        self.sched.move(rid, ReqState.WAITING)
        self._event(rid, "preempt", to="waiting", swap_failure="in")

    def _dispatch_swap(self, rid: int, direction: str,
                       gpu_runs: List[Tuple[int, int]], cpu_ids: List[int],
                       asynchronous: bool) -> None:
        """Dispatch one logical swap as ``swap_chunk_blocks``-sized chunk
        tasks (DESIGN.md §4.3).  Each chunk is its own task on the
        simulated stream with its own GPU-block conflict set and its own
        data-plane future, so (a) the pool lock is released between chunk
        copies — decode steps interleave with a long transfer — and (b) a
        fine-grained conflict sync waits only for the chunk whose blocks
        actually overlap, not the whole swap.  The data plane runs the
        staged run-coalesced path (``PagedPools.copy_*_staged``); a chunk
        whose CPU backing is shorter than its GPU runs (contamination
        capped the reuse copy) trims the copy to the backed prefix, and
        the sim cost still accounts the full dispatched runs.

        Data ordering: a copy touching CPU blocks that a still-queued
        swap-out writes (its own request's increment, or a contamination
        reallocation of a victim's blocks) must wait for that write;
        worker execution is not FIFO, so each chunk carries the
        overlapping out-futures as explicit dependencies (awaited before
        the pool lock — see ``MultithreadingSwapManager.data_deps``)."""
        pools = self.pools
        # a swap-out's gather must see the pool writes queued so far on
        # this thread's stream (the decode step in flight), and not the
        # steps launched after it, whenever its worker runs
        written = (pools.compute_event()
                   if pools is not None and direction == "out" else None)
        pos = 0
        for runs_c in split_runs(gpu_runs, self.config.swap_chunk_blocks):
            cnt = sum(n for _, n in runs_c)
            copy_fn = None
            cpu_c: List[int] = []
            deps: List = []
            if pools is not None:
                cpu_c = cpu_ids[pos:pos + cnt]
                if cpu_c:
                    deps = self.swap.data_deps(cpu_c)
                    data_runs = trim_runs(runs_c, len(cpu_c))
                    if direction == "out":
                        copy_fn = (lambda r=data_runs, c=cpu_c, e=written:
                                   pools.copy_out_staged(r, c, after=e))
                    else:
                        copy_fn = (lambda r=data_runs, c=cpu_c:
                                   pools.copy_in_staged(c, r))
            pos += cnt
            # deterministic fault injection (DESIGN.md §7): one draw per
            # chunk task, keyed by the per-(rid, direction) dispatch
            # sequence number — stable across runs and thread timing.
            # Wrapping also when copy_fn is None gives sim mode the same
            # failure surface as the real data plane.
            stall_us = 0.0
            if self.faults.enabled:
                seq = self._swap_seq.get((rid, direction), 0)
                self._swap_seq[(rid, direction)] = seq + 1
                spec = self.faults.swap_fault(rid, direction, seq)
                if spec is not None:
                    if spec.kind is not None:
                        copy_fn = FaultInjector.wrap_copy(spec, copy_fn)
                    stall_us = spec.stall_us
            self.swap.dispatch(self.clock, rid, direction,
                               self._transfer_runs(runs_c), self.block_bytes,
                               runs_to_indices(runs_c),
                               asynchronous=asynchronous, copy_fn=copy_fn,
                               copy_deps=deps, cpu_blocks=cpu_c,
                               extra_latency_us=stall_us)

    # ------------------------------------------------------------------
    # admission / prefill
    # ------------------------------------------------------------------

    def _preempt(self, rid: int) -> None:
        """Swap mode: KV to CPU, request -> SWAPPED.  Recompute mode: KV
        dropped, request -> WAITING for re-prefill.  A real-mode request
        caught MID chunked prefill has no pending decode token to resume
        from — it aborts to WAITING instead (the processed prefix is kept
        as a CPU reuse copy; re-admission opens a fresh prefill)."""
        req = self._req(rid)
        if self.pools is not None and req.prefill_remaining > 0:
            self._abort_chunked_prefill(rid)
            return
        self._swap_out(rid, keep_copy=True)
        if self.config.policy.preemption_mode == "recompute":
            self.sched.move(rid, ReqState.WAITING)
            self._event(rid, "preempt", to="waiting")
        else:
            self.sched.move(rid, ReqState.SWAPPED)
            self._event(rid, "preempt", to="swapped")

    def _abort_chunked_prefill(self, rid: int) -> None:
        """Mid-prefill preemption (real mode, DESIGN.md §5): drop the
        runner's carry buffers, keep the processed prefix as a CPU reuse
        copy (``context_tokens`` counts exactly the chunk-inserted
        tokens), roll back the turn's prompt extension and return the
        request to WAITING — the next ``_admit`` re-extends the turn's
        stored prompt and opens a fresh chunked prefill, reusing the
        saved prefix up to ``prefix_tokens``.

        A chunked recompute-mode RESUME (``prefill_is_resume``) has no
        prompt extension to roll back and no prefix worth keeping — the
        partial recompute is dropped whole and ``resume_tokens`` snaps
        back to the full context (a resume restarts from scratch)."""
        req = self._req(rid)
        self.runner.prefill_abort(rid)
        if req.prefill_is_resume:
            # recompute-mode branch of _swap_out: release + resume_tokens
            self._swap_out(rid, keep_copy=True)
            self.sched.move(rid, ReqState.WAITING)
            self._event(rid, "preempt", to="waiting", mid_prefill=True)
            return
        self._swap_out(rid, keep_copy=True, last_slot_written=True)
        req.prefill_remaining = 0
        req.resume_tokens = 0          # recompute mode: fresh _admit, not
        #                                a resume (no first token emitted)
        n_prompt = req.current_turn().prompt_tokens
        del req.token_history[len(req.token_history) - n_prompt:]
        self.sched.move(rid, ReqState.WAITING)
        self._event(rid, "preempt", to="waiting", mid_prefill=True)

    def _admit(self, rid: int) -> bool:
        """WAITING -> RUNNING via prefill (+prefix swap-in if CPU copy).
        Recompute-preempted requests re-prefill their whole context."""
        req = self._req(rid)
        if req.resume_tokens:
            return self._admit_resume(rid)
        turn = req.current_turn()
        # two sources of already-present KV: the GPU-pinned shared prefix
        # [0, shared) — no transfer at all — and the CPU reuse copy,
        # restored for [shared, reused).  ``reused`` >= ``shared`` by the
        # floor invariant (record_swap_out keeps valid_tokens at or above
        # the pinned prefix), so the two ranges tile.
        shared = self._shared_tokens(rid)
        reused = min(self.reuse.valid_tokens(rid), req.prefix_tokens)
        reused = max(reused, shared)
        new_ctx = req.prefix_tokens + turn.prompt_tokens
        try:
            self._gpu_alloc_tokens(rid, new_ctx - shared)
        except OutOfBlocksError:
            self.gpu_mgr.release_request(rid)   # roll back partial alloc
            return False
        gpu_runs = self.gpu_mgr.request_runs(rid)
        gpu_blocks = runs_to_indices(gpu_runs)
        self.swap.resolve_conflicts(self.clock, gpu_blocks)
        # prefix-with-prefill: reused tokens are swapped in, the rest computed
        if reused > shared:
            bs = self.config.block_size
            n_reused_blocks = (reused + bs - 1) // bs
            runs_in = self._runs_for_tokens(rid, shared, reused)
            cpu_ids = self.reuse.mgr.request_block_ids(rid)[
                shared // bs:n_reused_blocks] \
                if self.pools is not None else []
            self._dispatch_swap(rid, "in", runs_in, cpu_ids,
                                asynchronous=False)  # prefill needs it NOW
            if self.swap.has_failed(rid, "in"):
                # prefix restore failed terminally: degrade to a
                # reused=0 full prefill (DESIGN.md §7).  Void the copy —
                # this admission must not advertise a prefix it could
                # not restore — roll back the allocation and stay
                # WAITING; the next admission recomputes everything.
                # A FATAL failure propagates to the containment wrapper
                # and faults the request.
                tasks = self.swap.take_failed_for(rid)
                self.gpu_mgr.release_request(rid)
                self.reuse.invalidate(rid)
                fatal = [t.failed for t in tasks
                         if t.failed is not None and "Fatal" in t.failed]
                if fatal:
                    raise FatalSwapFault(fatal[0])
                return False
        # prefill compute for the non-reused tokens
        new_tokens = new_ctx - reused
        chunk = self.config.policy.chunked_prefill_tokens
        if chunk and self.pools is None and new_tokens > chunk:
            # BEYOND-PAPER (Sarathi-style): spread the prefill over
            # iterations so long prompts stop stalling the decode batch
            req.prefill_remaining = new_tokens
            req.context_tokens = new_ctx
            self.metrics.prefills += 1
            self.sched.move(rid, ReqState.RUNNING)
            self._event(rid, "admit", reused=reused, chunked=True)
            return True
        if chunk and self.pools is not None \
                and new_ctx - (reused - reused % self.config.block_size) \
                > chunk:
            # REAL-mode chunked prefill (DESIGN.md §5): the runner opens a
            # chunked-prefill state machine; step 5 advances it one
            # bucketed chunk per iteration between decode steps, so the
            # long prompt never freezes the decode batch.  The carry is
            # seeded from the restored ``reused`` prefix (bit-identical
            # to recomputing it), so the gate — like the compute and the
            # billing — covers only the tail beyond the block-aligned
            # reused prefix.
            self._begin_real_chunked_prefill(req, reused)
            self.metrics.prefills += 1
            self.sched.move(rid, ReqState.RUNNING)
            self._event(rid, "admit", reused=reused, chunked=True)
            return True
        t_prefill = self.iter_cost.prefill_us(max(new_tokens, 1))
        self.clock.advance(t_prefill)
        req.context_tokens = new_ctx
        self.metrics.prefills += 1
        if self.pools is not None:
            self._real_prefill(req, reused)
        self.sched.move(rid, ReqState.RUNNING)
        self._event(rid, "admit", reused=reused, chunked=False)
        self._emit_first_token(rid)
        return True

    def _allocate_token_slot(self, rid: int, skipped: Optional[set] = None
                             ) -> bool:
        """Allocate the one-token block slot the next decode will write
        KV into: on OutOfBlocksError preempt a victim (recorded in
        ``skipped`` so the caller drops it from this iteration's decode
        set) and retry; synchronize swap conflicts on any block the
        allocation acquired — it may be a just-freed block an async d2h
        copy is still reading (torn victim KV otherwise).  Returns False
        when the pool stays full."""
        before = set(self.gpu_mgr.request_block_ids(rid))
        try:
            self._gpu_alloc_tokens(rid, 1)    # evicts cached leaves first
        except OutOfBlocksError:
            victim = self._find_victim(exclude={rid})
            if victim is None:
                return False
            self._preempt(victim)
            if skipped is not None:
                skipped.add(victim)
            try:
                self._gpu_alloc_tokens(rid, 1)
            except OutOfBlocksError:
                return False
        grown = [b for b in self.gpu_mgr.request_block_ids(rid)
                 if b not in before]
        if grown:
            self.swap.resolve_conflicts(self.clock, grown)
        return True

    def _emit_first_token(self, rid: int) -> None:
        """The prompt's last position produced the response's first token."""
        if self.faults.enabled and self.faults.poisoned(rid):
            # poison hook: this request's compute path blows up (stands
            # in for a NaN logit / tokenizer crash); the containment
            # wrapper faults exactly this request
            self.faults.note_poison_fired()
            raise PoisonError(f"injected poison request (handle {rid})")
        req = self._req(rid)
        req.context_tokens += 1
        # stop check inline (not _hit_stop: ``generated`` is incremented
        # by finish_token below) — history IS current here: real-mode
        # prefill emits the first token synchronously
        sp = req.sampling
        first_stop = bool(self.pools is not None and sp is not None
                          and sp.stop_token_ids and req.token_history
                          and req.token_history[-1] in sp.stop_token_ids)
        if req.turn_done() or first_stop:
            # max_tokens == 1 (or the prompt's last position produced a
            # stop id straight away): the whole response is this one
            # token — no next-token slot, no decode step (without this
            # the decode loop over-generated by one token)
            reason = "length" if req.turn_done() else "stop"
            req.finish_token(self.clock.now_us)
            self.metrics.ttfts_us.append(req.ttfts_us[-1])
            self.metrics.total_tokens += 1
            self._credit(rid, first=True)
            self._event(rid, "first_token", ttft_us=req.ttfts_us[-1])
            self._finish_turn(rid, reason)
            return
        if not self._allocate_token_slot(rid):
            # a rebalance-time admission landed on a pool that stays full
            # even after the victim fallback: bounce THIS request; the
            # emitted token stays in its history and the resumption path
            # (swap-in / re-prefill) allocates its next-token slot
            req.finish_token(self.clock.now_us)
            self.metrics.ttfts_us.append(req.ttfts_us[-1])
            self.metrics.total_tokens += 1
            self._credit(rid, first=True)
            self._event(rid, "first_token", ttft_us=req.ttfts_us[-1])
            self._preempt(rid)
            return
        req.finish_token(self.clock.now_us)
        self.metrics.ttfts_us.append(req.ttfts_us[-1])
        self.metrics.total_tokens += 1
        self._credit(rid, first=True)
        self._event(rid, "first_token", ttft_us=req.ttfts_us[-1])

    def _admit_resume(self, rid: int) -> bool:
        """Re-admit a recompute-preempted request: re-prefill the full
        context (the recomputation cost the paper's swap mode avoids).
        With chunked prefill enabled the recomputation runs through the
        SAME chunked state machine as a fresh admission — one chunk per
        engine iteration interleaved with decode steps — instead of one
        monolithic re-prefill iteration; the completion emits NO first
        token (``prefill_is_resume``): the request already holds its
        pending token and resumes decoding."""
        req = self._req(rid)
        ctx = req.resume_tokens
        shared = self._shared_tokens(rid)    # pinned prefix: still resident
        try:
            self._gpu_alloc_tokens(rid, ctx - shared)
        except OutOfBlocksError:
            self.gpu_mgr.release_request(rid)   # roll back partial alloc
            return False
        # conflict sync covers only the newly allocated PRIVATE blocks
        # (pinned shared blocks are never swap sources or targets)
        self.swap.resolve_conflicts(
            self.clock, self.gpu_mgr.request_block_ids(rid))
        gpu_blocks = self._block_table(rid)
        # A sim-mode recompute preemption can land MID chunked prefill —
        # before the turn's first token existed (real mode can't reach
        # here: _abort_chunked_prefill reroutes those to a fresh admit).
        # Such a resume must still EMIT the first token on completion;
        # a resume of a decoding request (first_token_us set) must not.
        emitted = req.first_token_us is not None
        chunk = self.config.policy.chunked_prefill_tokens
        if chunk and ctx > chunk:
            if self.pools is not None:
                # the runner recomputes KV for all but the pending last
                # token, chunk by chunk; ``context_tokens`` stays at the
                # full context throughout (the blocks are allocated and
                # the token positions fixed — only the KV is re-filling)
                view = DecodeRequestView(rid, gpu_blocks, req.token_history,
                                         sampling=self._view_sampling(req))
                if shared:
                    # seed the carry from the pinned prefix: recomputing
                    # it would scatter into shared blocks
                    with self.swap._pool_lock:
                        req.prefill_remaining = self.runner.prefill_begin(
                            view, emit_first=False, reused_tokens=shared,
                            pool=self.pools.gpu)
                else:
                    req.prefill_remaining = self.runner.prefill_begin(
                        view, emit_first=False)
            else:
                req.prefill_remaining = ctx
            req.prefill_is_resume = emitted
            req.resume_tokens = 0
            self.metrics.prefills += 1
            self.sched.move(rid, ReqState.RUNNING)
            self._event(rid, "resume", tokens=ctx, chunked=True)
            return True
        self.clock.advance(self.iter_cost.prefill_us(max(ctx, 1)))
        self.metrics.prefills += 1
        if self.pools is not None:
            # recompute: regenerate KV for the already-known history
            self._real_reprefill(req)
        req.resume_tokens = 0
        self.sched.move(rid, ReqState.RUNNING)
        self._event(rid, "resume", tokens=ctx, chunked=False)
        if not emitted:
            self._emit_first_token(rid)
        return True

    def _real_reprefill(self, req: Request) -> None:
        """Recompute-preemption resume: the runner regenerates KV for the
        already-known history (all but the last token — its K/V is written
        by the next decode step, which consumes hist[-1] as input) and
        inserts it through its persistent block tables.  A pinned shared
        prefix seeds the carry instead of being recomputed — recomputing
        it would scatter into blocks other sharers are reading."""
        rid = req.rid
        view = DecodeRequestView(rid, self._block_table(rid),
                                 req.token_history,
                                 sampling=self._view_sampling(req))
        shared = self._shared_tokens(rid)
        if shared:
            with self.swap._pool_lock:   # the carry seed reads the pool
                total = self.runner.prefill_begin(
                    view, emit_first=False, reused_tokens=shared,
                    pool=self.pools.gpu)
        else:
            total = self.runner.prefill_begin(view, emit_first=False)
        # KV compute runs OUTSIDE the pool lock (it never touches the
        # pool); only the scatter + rebind serialize with swap copies
        staged = self.runner.prefill_chunk_compute(rid, total)
        with self.swap._pool_lock:
            self.pools.gpu = self.runner.prefill_insert(
                view, self.pools.gpu, staged)

    # ------------------------------------------------------------------
    # real-model data plane
    # ------------------------------------------------------------------

    def _extend_prompt(self, req: Request) -> DecodeRequestView:
        """Extend the token history with the current turn's prompt ids
        (supplied by the client at add_request/continue_session time)
        and build the runner view for its prefill."""
        rid = req.rid
        hist = req.token_history
        self.runner.flush()          # history must be current before extend
        turn = req.current_turn()
        assert turn.prompt_ids is not None, \
            "real mode needs prompt token ids (add_request got a count?)"
        hist.extend(turn.prompt_ids)
        req.hist_emitted = len(hist)     # stream deltas = response tokens
        return DecodeRequestView(rid, self._block_table(rid),
                                 hist, sampling=self._view_sampling(req))

    def _real_prefill(self, req: Request, reused: int = 0) -> None:
        """Runner-managed whole-prompt prefill: extend the turn's prompt,
        then the runner computes KV, inserts it through its persistent
        block tables (device-side scatter — no host KV round-trip) and
        emits the first response token (device-side sampling; greedy at
        temperature 0).  With ``reused`` > 0 the carry is seeded from the
        prefix the admission just restored into the pool
        (``ops.seed_prefill_carry`` — bit-identical to recomputing), so
        the monolithic path — like the chunked one — never recomputes a
        re-admitted prefix."""
        view = self._extend_prompt(req)
        rid = req.rid
        if reused > 0:
            with self.swap._pool_lock:   # the carry seed reads the pool
                total = self.runner.prefill_begin(
                    view, emit_first=True, reused_tokens=reused,
                    pool=self.pools.gpu)
        else:
            total = self.runner.prefill_begin(view, emit_first=True)
        # KV compute + first-token draw run OUTSIDE the pool lock; only
        # the scatter + rebind serialize with swap copies
        staged = self.runner.prefill_chunk_compute(rid, total)
        self.runner.prefill_emit_first(rid)
        with self.swap._pool_lock:
            self.pools.gpu = self.runner.prefill_insert(
                view, self.pools.gpu, staged)
        self._prefix_insert(req)

    def _prefix_insert(self, req: Request) -> None:
        """Donate a freshly prefilled FIRST-turn prompt's full blocks to
        the prefix tree (the block holding the last prompt token doubles
        as the first decode slot and stays private).  Only turn 0
        qualifies: later turns' prompts sit beyond decode tokens unique
        to this conversation, so no other request could ever match them.
        The donated blocks stay physically in place — the request keeps
        using them, now as mapped shared blocks."""
        if self.prefix is None or req.turn_idx != 0:
            return
        ids = req.current_turn().prompt_ids
        if not ids:
            return
        self.prefix.insert(req.rid, list(ids),
                           now_us=self.clock.now_us,
                           priority=self.sched.priority(req.rid))

    def _begin_real_chunked_prefill(self, req: Request,
                                    reused: int) -> None:
        """Open the runner's chunked-prefill state machine for a newly
        admitted request (DESIGN.md §5).  The carry is seeded from the
        ``reused`` prefix the admission just restored into the pool, so
        only the non-reused tail is computed AND billed — matching the
        sim-mode chunked accounting (the prefix's transfer cost was
        already charged by the synchronous swap-in).  ``context_tokens``
        tracks the tokens whose KV is resident and claimable (seeded
        prefix + chunk inserts), so a mid-prefill preemption swaps out
        exactly the processed prefix; ``prefill_remaining`` counts the
        tokens left to compute — step 5 advances one chunk per
        iteration."""
        view = self._extend_prompt(req)
        with self.swap._pool_lock:      # the carry seed reads the pool
            req.prefill_remaining = self.runner.prefill_begin(
                view, emit_first=True, reused_tokens=reused,
                pool=self.pools.gpu)
        req.context_tokens = len(req.token_history) - req.prefill_remaining

    def _real_prefill_chunk(self, rid: int) -> int:
        """Advance one request's in-flight chunked prefill by one chunk:
        compute OUTSIDE the pool lock (the forward touches no pool
        state), insert the chunk's KV under it, and on the final chunk
        emit the first token.  Non-final chunks are trimmed to block-size
        multiples so every insert stays block-aligned.  A chunked RESUME
        (recompute re-prefill) neither advances ``context_tokens`` (the
        full context was re-allocated up front) nor emits a first token.
        Returns the chunk token count (charged to the sim clock by the
        caller)."""
        if self.faults.enabled and self.faults.poisoned(rid):
            self.faults.note_poison_fired()
            raise PoisonError(f"injected poison request (handle {rid})")
        req = self._req(rid)
        bs = self.config.block_size
        n = min(self.config.policy.chunked_prefill_tokens,
                req.prefill_remaining)
        if n < req.prefill_remaining:
            n -= n % bs
            if n == 0:                 # chunk smaller than one block
                n = min(bs, req.prefill_remaining)
        staged = self.runner.prefill_chunk_compute(rid, n)
        with self.swap._pool_lock:
            self.pools.gpu = self.runner.prefill_chunk_insert(
                rid, self.pools.gpu, staged)
        req.prefill_remaining -= n
        if not req.prefill_is_resume:
            req.context_tokens += n
        if req.prefill_remaining == 0:
            self.runner.prefill_finish(rid)
            if req.prefill_is_resume:
                req.prefill_is_resume = False
            else:
                self._prefix_insert(req)
                self._emit_first_token(rid)
        return n

    def _real_decode(self, rids: List[int]) -> None:
        """Batched paged decode through the device-resident runner: only
        changed block-table rows are uploaded, the pool is donated, and
        the next-token host sync is deferred to the next iteration's
        decode (overlapping this step with the next control plane)."""
        views = [DecodeRequestView(r, self._block_table(r),
                                   self._req(r).token_history,
                                   sampling=self._view_sampling(self._req(r)))
                 for r in rids]
        with self.swap._pool_lock:
            self.pools.gpu = self.runner.decode(views, self.pools.gpu)

    # ------------------------------------------------------------------
    # the iteration
    # ------------------------------------------------------------------

    def step(self, until_us: Optional[float] = None) -> List[RequestOutput]:
        """Advance the engine one iteration and return this step's
        incremental per-request outputs (token deltas, first-token and
        finish markers — aborts issued since the previous step are
        folded in too).  ``until_us``: the caller's next known event
        (arrival, wake-up); an idle engine advances its clock no further
        than that, so open-world drivers control time without the engine
        polling."""
        t_wall0 = time.perf_counter()
        m = self.metrics
        bs = self.config.block_size
        prefills_before = m.prefills

        # Step 0 (robustness, DESIGN.md §7): watchdog-escalate stuck swap
        # tasks, surface copy retries as events, run the recovery ladder
        # over terminally failed copies, and apply this iteration's
        # injected allocation pressure.
        if self.config.swap_watchdog_us > 0:
            for t in self.swap.watchdog_check(self.clock,
                                              self.config.swap_watchdog_us):
                self._event(t.req_id, "retry", watchdog=True,
                            direction=t.direction)
        for rec in self.swap.drain_retries():
            self._event(rec["rid"], "retry", direction=rec["direction"],
                        attempt=rec["attempt"], error=rec["error"])
        self._process_failed_swaps()
        if self.faults.enabled:
            self._apply_alloc_pressure()

        # Step 1: completed async swap-ins -> running.  A swap-in may
        # consist of several chunk tasks, and a fine-grained conflict sync
        # (resolve_conflicts) can retire tasks between polls; a request is
        # resident — promote it — exactly when NO in-flight swap-in task
        # remains for it (it would otherwise be stranded in SWAPPING_IN).
        self.swap.poll_completed(self.clock)
        if self.sched.swapping_in:
            ongoing = {t.req_id for t in self.swap.ongoing_swap_in}
            for rid in list(self.sched.swapping_in):
                if rid not in ongoing:
                    self.sched.move(rid, ReqState.RUNNING)
                    self._event(rid, "promote")

        # Step 2: budget safeguard — a request whose working set exceeds
        # the whole GPU pool can never be served; fail it instead of
        # deadlocking the queue.
        budget = self._budget_tokens()
        for rid in list(self.sched.waiting):
            req = self._req(rid)
            need = max(req.target_tokens,
                       req.prefix_tokens + req.current_turn().prompt_tokens
                       + bs)
            if need > budget:
                import warnings
                warnings.warn(f"request {rid} needs {need} tokens "
                              f"> pool budget {budget}; dropping")
                self.abort(rid, reason="dropped")

        # Step 3: priority update -> rebalance
        updated = self.sched.step_trace()
        if updated:
            desired = self.sched.desired_running(
                self._budget_tokens(), bs,
                batch_bucket=(self.runner.batch_bucket
                              if self.runner is not None else 0))
            to_preempt, to_swap_in, to_admit = \
                self.sched.classify_rebalance(desired)
            for rid in to_preempt:
                self._contained(rid, self._preempt, rid)
            for rid in to_swap_in:
                self._contained(rid, self._swap_in, rid)
            for rid in to_admit:
                self._contained(rid, self._admit, rid)

        # Step 4: opportunistic admission (space permitting), capped at
        # the batch-bucket-aware target instead of max_running outright
        for rid in sorted(list(self.sched.waiting),
                          key=self.sched.priority, reverse=True):
            free_tok = self.gpu_mgr.free_blocks() * bs
            req = self._req(rid)
            # the pinned shared prefix is already resident: only the
            # private tail needs free space
            need = (req.prefix_tokens + req.current_turn().prompt_tokens
                    + bs - self._shared_tokens(rid))
            if need > free_tok \
                    or len(self.sched.running) + len(self.sched.swapping_in) \
                    >= self._admission_target():
                break
            self._contained(rid, self._admit, rid)
        for rid in list(self.sched.swapped):
            if len(self.sched.running) + len(self.sched.swapping_in) \
                    >= self._admission_target():
                break
            free_tok = self.gpu_mgr.free_blocks() * bs
            if (self._req(rid).context_tokens + bs
                    - self._shared_tokens(rid)) > free_tok:
                break
            self._contained(rid, self._swap_in, rid)

        # Step 5: decode one token for the running batch.  Requests with
        # an in-flight chunked prefill advance their prefill instead of
        # decoding (one chunk per iteration, piggybacked on the batch).
        # First retire stop-token hits from the PREVIOUS decode — their
        # last token ended the turn and must not enter this batch.
        if self.pools is not None:
            self._apply_stop_tokens()
        rids = [r for r in self.sched.running
                if self._req(r).prefill_remaining == 0]
        prefilling = [r for r in self.sched.running
                      if self._req(r).prefill_remaining > 0]
        chunk_tokens = 0
        if prefilling:
            # at most ONE prompt chunk per iteration (highest priority
            # first) interleaved with the decode batch — the Sarathi-style
            # fairness lever bounding tail TBT during admission bursts
            chunk = self.config.policy.chunked_prefill_tokens
            rid_p = max(prefilling, key=self.sched.priority)
            reqp = self._req(rid_p)
            if self.pools is not None:
                chunk_tokens = self._contained(
                    rid_p, self._real_prefill_chunk, rid_p) or 0
            else:
                chunk_tokens = min(chunk, reqp.prefill_remaining)
                reqp.prefill_remaining -= chunk_tokens
                if reqp.prefill_remaining == 0:
                    if reqp.prefill_is_resume:
                        reqp.prefill_is_resume = False
                    else:
                        self._contained(rid_p, self._emit_first_token,
                                        rid_p)
        if rids or prefilling:
            # block allocation for the new token (conflict-checked in
            # _allocate_token_slot).  Iterate over a SNAPSHOT and track a
            # ``skipped`` set: a victim preempted from inside the batch
            # must not shift the iteration (the old in-place
            # ``rids.remove`` silently skipped the next request's
            # allocation while still decoding and crediting it), and a
            # request whose allocation failed must sit this iteration out
            # entirely — decoding it anyway would advance
            # ``context_tokens`` past its block table (desync).
            skipped: set = set()
            for rid in list(rids):
                if rid in skipped or rid not in self.sched.running:
                    continue       # preempted as a victim earlier this loop
                if not self._contained(rid, self._allocate_token_slot,
                                       rid, skipped):
                    skipped.add(rid)           # retry next iteration
            decode_rids = [r for r in rids if r not in skipped
                           and r in self.sched.running]
            if decode_rids and self.pools is not None:
                self._real_decode(decode_rids)
            total_ctx = sum(self._req(r).context_tokens for r in decode_rids)
            t_iter = self.iter_cost.decode_iter_us(len(decode_rids),
                                                   total_ctx)
            if chunk_tokens:
                t_iter += self.iter_cost.prefill_us(chunk_tokens) \
                    - self.iter_cost.hw.iter_overhead_us
            if not decode_rids and not chunk_tokens:
                # everyone was skipped (pool exhausted, no victim): charge
                # the iteration overhead so the sim clock still advances
                t_iter = self.iter_cost.hw.iter_overhead_us
            if decode_rids:
                # feed the adaptive swap profiler the overlap window one
                # decode iteration offers (decide_async cost model)
                self.swap.note_decode_iter(t_iter)
            self.clock.advance(t_iter)
            for rid in decode_rids:
                req = self._req(rid)
                req.context_tokens += 1
                req.finish_token(self.clock.now_us)
                m.total_tokens += 1
                if req.tbts_us:
                    m.tbts_us.append(req.tbts_us[-1])
                self._credit(rid)
                if req.turn_done():
                    self._finish_turn(rid)
            m.iter_records.append((self.clock.now_us, len(decode_rids),
                                   t_iter, m.prefills - prefills_before,
                                   self.swap.total_stall_us))
        else:
            # idle: advance to the next event (the caller's next arrival
            # or wake-up, or an in-flight swap-in completing)
            self._advance_idle(until_us)

        m.iterations += 1
        m.total_time_us = self.clock.now_us
        m.ctx_switch_stall_us = self.swap.total_stall_us

        # run the recovery ladder again over failures surfaced DURING
        # this step (inline sim copies, fast workers): a terminally
        # failed copy in the engine's final step would otherwise sit in
        # the failed queue forever — the drain loop stops calling step()
        self._process_failed_swaps()

        # injected allocation pressure dies with the last live request —
        # an emptied engine must reclaim the phantom reserve THIS step
        # (the drain loop stops calling step() once has_work is False)
        if self._pressure_blocks and not self.sched.requests:
            self.gpu_mgr.release_request(self._PRESSURE_RID)
            self._pressure_blocks = 0

        # invariant sanitizer (DESIGN.md §7): cross-layer state check
        # every N steps; raises InvariantViolation with a state dump —
        # deliberately NOT contained (corrupt engine state has no single
        # owning request; continuing would serve garbage)
        n_inv = self.config.check_invariants_every
        if n_inv > 0 and m.iterations % n_inv == 0:
            check_engine_invariants(self)
            m.invariant_checks += 1

        m.callstack_wall_s += time.perf_counter() - t_wall0
        return self._collect_outputs()

    def _process_failed_swaps(self) -> None:
        """Recovery ladder over terminally failed copies surfaced since
        the last step (worker d2h gathers fail ASYNCHRONOUSLY — inline
        swap-in failures were already handled at their dispatch site;
        this drain is their backstop).  A failed swap-OUT means the CPU
        copy's increment never arrived: the copy is voided, and a
        SWAPPED request whose resumption depended on it converts to a
        recompute-mode resume (KV regenerated from token history).
        Fatal failures end in a request fault; failures of finished /
        aborted requests need nothing beyond the voided copy."""
        for t in self.swap.take_failed():
            rid = t.req_id
            req = self.sched.requests.get(rid)
            if t.direction == "in":
                if req is not None:
                    self._recover_swap_in_failure(rid)
                continue
            self.reuse.invalidate(rid)
            if req is None:
                continue        # finished/parked/aborted: copy voided
            if t.failed is not None and "Fatal" in t.failed:
                self._fault_request(rid, FatalSwapFault(t.failed))
                continue
            if req.state is ReqState.SWAPPED:
                # the CPU KV this request would swap back in is
                # incomplete: resume by recomputation instead
                req.resume_tokens = req.context_tokens
                req.prefill_remaining = 0
                req.prefill_is_resume = False
                self.metrics.swap_failure_resumes += 1
                self.sched.move(rid, ReqState.WAITING)
                self._event(rid, "preempt", to="waiting",
                            swap_failure="out")

    _PRESSURE_RID = -7777       # phantom owner of injected-reserve blocks

    def _apply_alloc_pressure(self) -> None:
        """Allocation-pressure injection: a phantom request holds the
        plan's reserved blocks for the spike window, so the shortage
        flows through every real path — admission gating, token-slot
        allocation, victim preemption — rather than a bolted-on check.
        Released as the window closes (and whenever the engine is empty,
        so drained runs can never leak phantom blocks)."""
        want = self.faults.reserved_blocks(self.metrics.iterations) \
            if self.sched.requests else 0
        if want == self._pressure_blocks:
            return
        self.gpu_mgr.release_request(self._PRESSURE_RID)
        self._pressure_blocks = 0
        if want > 0:
            try:
                bs = self.config.block_size
                self.gpu_mgr.allocate_tokens(self._PRESSURE_RID, want * bs)
                self.gpu_mgr.note_tokens(self._PRESSURE_RID, want * bs)
                self._pressure_blocks = want
            except OutOfBlocksError:
                # pool already under real pressure: the spike is moot
                self.gpu_mgr.release_request(self._PRESSURE_RID)

    def _collect_outputs(self) -> List[RequestOutput]:
        outs = list(self._outs.values())
        self._outs = {}
        if self.stream_tokens and self.runner is not None:
            # materialize this step's token ids for streaming clients —
            # the one deliberate host sync of the online path (the
            # deferred-sync overlap is the price of live token deltas)
            self.runner.flush()
        for out in outs:
            req = self.sched.requests.get(out.handle) \
                or self.parked.get(out.handle)
            if (self.stream_tokens and req is not None
                    and self.pools is not None and out.token_ids is None):
                hist = req.token_history
                out.token_ids = hist[req.hist_emitted:]
                req.hist_emitted = len(hist)
        return outs

    def _finish_turn(self, rid: int, reason: str = "length") -> None:
        req = self._req(rid)
        if self.runner is not None:
            self.runner.flush()      # materialize the turn's last tokens
            # free the decode row eagerly (same as abort): the lazy
            # `_update_rows` release only runs at the NEXT decode batch,
            # and a finished request must not hold a row (or trip the
            # sanitizer's D2 check) waiting for a decode that may never
            # come
            self.runner.release(rid)
        if reason == "length" and self._hit_stop(req):
            # the turn's LAST token (max_tokens boundary) was a stop id:
            # the response ended by matching, not by running out — the
            # stop reason wins (clients branch on it for follow-ups)
            reason = "stop"
        if req.token_history:
            self._token_hist_by_conv[rid] = list(req.token_history)
        # retain the KV copy for the next turn (reuse mechanism); baseline
        # swaps the whole context out; recompute mode just frees
        self._swap_out(rid, keep_copy=True)
        req.resume_tokens = 0       # a follow-up turn is a fresh prefill
        for q in (self.sched.waiting, self.sched.running,
                  self.sched.swapped, self.sched.swapping_in):
            if rid in q:
                q.remove(rid)
        self._record_slo(req, reason)
        out = self._out(rid)
        out.finished, out.finish_reason = True, reason
        out.generated, out.context_tokens = req.generated, req.context_tokens
        if self.stream_tokens and self.pools is not None:
            # fill the final delta HERE (history is flushed above): a
            # non-retained request is gone before _collect_outputs runs
            out.token_ids = req.token_history[req.hist_emitted:]
            req.hist_emitted = len(req.token_history)
        if req.retain_kv:
            req.state = ReqState.FINISHED
            self.parked[rid] = req
            del self.sched.requests[rid]
            self._event(rid, "finish", retained=True, tokens=req.generated,
                        reason=reason)
        else:
            req.state = ReqState.DONE
            self.reuse.release(rid)
            if self.prefix is not None:
                self.prefix.release(rid)    # unpin the shared prefix
            del self.sched.requests[rid]
            self.sched.clear_priority(rid)
            self._event(rid, "finish", retained=False, tokens=req.generated,
                        reason=reason)

    def _advance_idle(self, until_us: Optional[float] = None) -> None:
        events = [t.done_at for t in self.swap.ongoing_swap_in]
        if until_us is not None:
            events.append(until_us)
        if events:
            self.clock.advance_to(max(min(events), self.clock.now_us + 100.0))
        else:
            self.clock.advance(1000.0)

    def _admission_target(self) -> int:
        """Batch-bucket-aware admission cap (real mode).  The decode step
        executes the next pow2 batch regardless of occupancy, so filling
        the compiled bucket is FREE (padded rows already run) while
        spilling a boundary doubles the padded batch and compiles a new
        variant.  Admission therefore targets the current bucket and only
        crosses a boundary when the candidates would fill at least half
        of the next bucket's new rows — with a bounded hold (16
        iterations) so a lone straggler is never starved; the priority
        rebalance path is never gated.  Sim mode — and a cold runner with
        no compiled variant to protect yet — keeps the plain
        ``max_running`` cap."""
        cap = self.config.max_running
        if self.runner is None or self.runner.batch_bucket == 0:
            return cap
        cur = len(self.sched.running) + len(self.sched.swapping_in)
        bucket = self.runner.batch_bucket
        while bucket < cur:
            bucket *= 2
        if cur < min(bucket, cap):
            self._bucket_hold = 0       # not at a boundary: no hold episode
            return min(bucket, cap)
        waiting = len(self.sched.waiting) + len(self.sched.swapped)
        if waiting == 0:
            self._bucket_hold = 0       # episode ended without crossing
            return min(bucket, cap)
        if waiting >= max(1, bucket // 2) or self._bucket_hold >= 16:
            self._bucket_hold = 0
            return min(bucket * 2, cap)
        if self.metrics.iterations != self._bucket_hold_iter:
            # count the hold once per engine iteration, not per call
            self._bucket_hold += 1
            self._bucket_hold_iter = self.metrics.iterations
        return min(bucket, cap)

    def _find_victim(self, exclude) -> Optional[int]:
        victims = self.sched.victims_for_space(exclude)
        return victims[0] if victims else None

    # ------------------------------------------------------------------

    def shutdown(self) -> None:
        if self.runner is not None:
            self.runner.flush()
        self.swap.shutdown()
