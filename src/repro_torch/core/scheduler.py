"""Priority scheduler — FastSwitch's fairness-aware preemptive scheduling.

Maintains the waiting / running / swapped queues, applies the offline
priority trace, and on every priority update reorders requests across the
queues to match the new priorities under the GPU block budget (paper §4:
"the scheduler then reorders requests across waiting, running and swapped
queues to meet the updated priority requirements").
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.data.sharegpt import Conversation


class ReqState(enum.Enum):
    WAITING = "waiting"          # needs (re-)admission + prefill
    RUNNING = "running"          # in the decode batch
    SWAPPED = "swapped"          # preempted; KV on CPU
    SWAPPING_IN = "swapping_in"  # async swap-in in flight
    FINISHED = "finished"        # turn done, KV retained for continue_session
    DONE = "done"


@dataclass
class Request:
    """One conversation being served (state spans turns)."""
    conv: Conversation
    turn_idx: int = 0
    state: ReqState = ReqState.WAITING
    context_tokens: int = 0       # tokens currently represented in KV
    target_tokens: int = 0        # context length when this turn completes
    prefix_tokens: int = 0        # context before this turn's prompt
    # metrics (sim us)
    turn_arrival_us: float = 0.0
    first_token_us: Optional[float] = None
    token_times_us: List[float] = field(default_factory=list)
    ttfts_us: List[float] = field(default_factory=list)
    tbts_us: List[float] = field(default_factory=list)
    generated: int = 0
    token_history: List[int] = field(default_factory=list)  # real mode
    resume_tokens: int = 0   # recompute-preemption: context to re-prefill
    prefill_remaining: int = 0   # chunked prefill: tokens still to process
    prefill_is_resume: bool = False  # chunked RECOMPUTE resume: no first
    #                                  token on completion (serving §6)
    # positions [lo, hi) that the last swap-in left without KV (its copy
    # was valid only to lo) and no recomputation has written since; set
    # by every path into RUNNING, read by invariant R3
    kv_gap: Optional[Tuple[int, int]] = None
    # serving-API surface (core/serving.py): per-request parameters and
    # streaming / SLO bookkeeping
    sampling: object = None        # request_api.SamplingParams
    slo: object = None             # request_api.SLOSpec | None
    retain_kv: bool = False        # park the finished turn for follow-ups
    tbt_mark: int = 0              # len(tbts_us) at begin_turn (turn slice)
    hist_emitted: int = 0          # history prefix already streamed out

    @property
    def rid(self) -> int:
        return self.conv.conv_id

    def current_turn(self):
        return self.conv.turns[self.turn_idx]

    def begin_turn(self, now_us: float) -> None:
        t = self.current_turn()
        self.prefix_tokens = self.context_tokens
        self.target_tokens = self.context_tokens + t.prompt_tokens + t.response_tokens
        self.turn_arrival_us = now_us
        self.first_token_us = None
        self.generated = 0
        self.tbt_mark = len(self.tbts_us)

    def finish_token(self, now_us: float) -> None:
        if self.first_token_us is None:
            self.first_token_us = now_us
            self.ttfts_us.append(now_us - self.turn_arrival_us)
        else:
            self.tbts_us.append(now_us - self.token_times_us[-1])
        self.token_times_us.append(now_us)
        self.generated += 1

    def turn_done(self) -> bool:
        return self.context_tokens >= self.target_tokens


class PriorityScheduler:
    def __init__(self, trace, max_running: int = 48):
        self.trace = trace
        self.max_running = max_running
        self.requests: Dict[int, Request] = {}
        self.waiting: List[int] = []
        self.running: List[int] = []
        self.swapped: List[int] = []
        self.swapping_in: List[int] = []
        # admission-layer priority overrides (DESIGN.md §11): a front-end
        # maps SLO tightness onto scheduler priority here, so deadlines —
        # not the synthetic trace — drive preemption for its requests.
        # Requests without an override keep the trace's priority.
        self.extern: Dict[int, float] = {}

    # ------------------------------------------------------------------

    def add_request(self, req: Request) -> None:
        self.requests[req.rid] = req
        self.waiting.append(req.rid)
        req.state = ReqState.WAITING

    def priority(self, rid: int) -> float:
        p = self.extern.get(rid)
        return p if p is not None else self.trace.priority(rid)

    def set_priority(self, rid: int, priority: float) -> None:
        self.extern[rid] = float(priority)

    def clear_priority(self, rid: int) -> None:
        self.extern.pop(rid, None)

    def active_ids(self) -> List[int]:
        return self.waiting + self.running + self.swapped + self.swapping_in

    def step_trace(self) -> bool:
        return self.trace.step(self.active_ids(), self.running)

    # ------------------------------------------------------------------

    def desired_running(self, block_budget_tokens: int,
                        block_size: int, batch_bucket: int = 0) -> List[int]:
        """Top-priority active requests that fit the GPU token budget.

        ``batch_bucket`` > 0 (the real-mode runner's compiled pow2 decode
        bucket) enables padded-batch economics: the decode step always
        executes the next pow2 rows, so spilling a bucket boundary by a
        straggler or two doubles the padded batch for little useful work.
        The spill is trimmed back to the boundary — lowest-priority
        ADMISSIONS first, never a currently running request (no
        preemption for bucket aesthetics) — unless it fills at least half
        of the next bucket's new rows."""
        cands = sorted(self.active_ids(), key=self.priority, reverse=True)
        chosen: List[int] = []
        budget = block_budget_tokens
        for rid in cands:
            if len(chosen) >= self.max_running:
                break
            req = self.requests[rid]
            # footprint: current context + headroom of one block
            need = max(req.context_tokens,
                       req.prefix_tokens + req.current_turn().prompt_tokens) \
                + block_size
            if need <= budget:
                chosen.append(rid)
                budget -= need
        if batch_bucket > 0 and len(chosen) > batch_bucket:
            boundary = batch_bucket
            while boundary * 2 <= len(chosen):
                boundary *= 2
            spill = len(chosen) - boundary
            if spill < max(1, boundary // 2):
                running = set(self.running)
                # lowest-priority first, skipping (never trimming) running
                # requests wherever they sit in the tail
                for i in range(len(chosen) - 1, -1, -1):
                    if len(chosen) <= boundary:
                        break
                    if chosen[i] not in running:
                        chosen.pop(i)
        return chosen

    def classify_rebalance(self, desired: List[int]
                           ) -> Tuple[List[int], List[int], List[int]]:
        """Returns (to_preempt, to_swap_in, to_admit)."""
        dset = set(desired)
        to_preempt = [r for r in self.running if r not in dset]
        to_swap_in = [r for r in self.swapped if r in dset]
        to_admit = [r for r in self.waiting if r in dset]
        return to_preempt, to_swap_in, to_admit

    # -- state transitions -------------------------------------------------

    def move(self, rid: int, dst: ReqState) -> None:
        req = self.requests[rid]
        for q in (self.waiting, self.running, self.swapped, self.swapping_in):
            if rid in q:
                q.remove(rid)
        req.state = dst
        if dst == ReqState.WAITING:
            self.waiting.append(rid)
        elif dst == ReqState.RUNNING:
            self.running.append(rid)
        elif dst == ReqState.SWAPPED:
            self.swapped.append(rid)
        elif dst == ReqState.SWAPPING_IN:
            self.swapping_in.append(rid)
        # FINISHED / DONE live outside the queues

    def shed_order(self, doomed: Set[int]) -> List[int]:
        """Overload shedding order over the WAITING queue (DESIGN.md §7):
        least valuable first — requests already doomed to miss their TTFT
        SLO (``doomed``, computed by the engine's queue model) before
        viable ones, then lowest priority, then newest arrival (oldest
        waiters have accumulated the most queueing investment; shedding
        them wastes it and is the classic late-drop pathology)."""
        return sorted(self.waiting,
                      key=lambda r: (r not in doomed, self.priority(r),
                                     -self.requests[r].turn_arrival_us))

    def victims_for_space(self, exclude: Set[int]) -> List[int]:
        """Lowest-priority running requests first (preemption order).
        At equal priority a request still mid chunked prefill
        (``prefill_remaining`` > 0) is preempted LAST: aborting it
        forfeits the prefill chunks already computed (real mode inserts
        them into the pool and would recompute them on re-admission),
        while a decoding victim resumes from its swapped KV at full
        value."""
        return sorted((r for r in self.running if r not in exclude),
                      key=lambda r: (self.priority(r),
                                     self.requests[r].prefill_remaining > 0))
