"""Trace-replay client of the open-world serving core.

``FastSwitchEngine`` used to BE the engine: it consumed a pre-sorted
conversation trace and ran the iteration loop itself, with arrivals and
turn wake-ups hardwired into ``step()``.  The engine core now lives in
``core/serving.py`` (``ServingEngine`` — vLLM-shaped
``add_request()/step() -> RequestOutput`` with runtime cancellation and
session continuation); this module keeps the old trace-driven interface
as a thin CLIENT of that API:

  * arrivals: conversations whose ``arrival_s`` has passed are submitted
    with ``add_request`` (real mode synthesizes the deterministic
    per-(conv, turn) prompt ids the engine used to make internally);
  * wake-ups: a finished turn with a successor parks its KV in the core
    (``retain_kv``) and sleeps client-side for ``think_time_s``; the
    wake-up is a ``continue_session`` follow-up through the KV-reuse
    path — exactly what an interactive user does;
  * idle time: the client passes its next known event (arrival or wake)
    as ``step(until_us=...)`` so the core's idle clock advances exactly
    as the pre-refactor engine's did (bit-exact replay parity).

Everything else — queues, swaps, metrics, the GPU pools — is the core's;
attribute access falls through to it, so existing callers (benchmarks,
tests) keep working unchanged.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.faults import EngineDrainingError, EngineOverloadError
from repro_torch.core.request_api import RequestOutput, SamplingParams, SLOSpec
from repro_torch.core.serving import EngineMetrics, ServingEngine  # noqa: F401
from repro_torch.data.priority import PriorityTrace
from repro_torch.data.sharegpt import Conversation, prompt_for_turn


class _Wake:
    """One parked conversation awaiting its next-turn wake-up."""
    __slots__ = ("wake_s", "conv", "turn_idx")

    def __init__(self, wake_s: float, conv: Conversation, turn_idx: int):
        self.wake_s, self.conv, self.turn_idx = wake_s, conv, turn_idx


class FastSwitchEngine:
    """Replay a conversation trace through the serving API.

    Same constructor and surface as the pre-refactor engine; ``run()``
    drives ``ServingEngine.add_request / continue_session / step`` and
    is bit-exact with the pre-refactor replay (test_decode_consistency).
    """

    def __init__(self, config, conversations: List[Conversation],
                 trace: Optional[PriorityTrace] = None,
                 model_bundle: Optional[dict] = None,
                 slo: Optional[SLOSpec] = None):
        # keep_events=False: a closed-world replay never reads the event
        # stream, and a 300k-iteration benchmark run would accumulate an
        # unbounded RequestEvent list for nothing
        self.core = ServingEngine(config, trace=trace,
                                  model_bundle=model_bundle,
                                  keep_events=False)
        self.pending = sorted(conversations, key=lambda c: c.arrival_s)
        self.sleeping: List[_Wake] = []
        self.default_slo = slo
        self._convs = {c.conv_id: c for c in conversations}
        self.dropped_submits = 0

    # attribute fall-through: the core owns all engine state (sched,
    # gpu_mgr, swap, reuse, clock, metrics, pools, runner, config, ...)
    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "core"), name)

    # ------------------------------------------------------------------

    def _prompt_for(self, conv: Conversation, turn_idx: int):
        """Real mode: the deterministic per-(conv, turn) synthetic prompt
        ids (same stream the engine used to generate internally — replay
        parity).  Sim mode: just the token count."""
        vocab = None if self.core.pools is None \
            else self.core.model_bundle["cfg"].vocab_size
        return prompt_for_turn(conv, turn_idx, vocab)

    def _submit(self, conv: Conversation, turn_idx: int) -> None:
        turn = conv.turns[turn_idx]
        sp = SamplingParams(max_tokens=turn.response_tokens)
        retain = turn_idx + 1 < len(conv.turns)
        try:
            if turn_idx == 0:
                self.core.add_request(self._prompt_for(conv, turn_idx), sp,
                                      slo=self.default_slo,
                                      handle=conv.conv_id, retain_kv=retain)
            else:
                self.core.continue_session(conv.conv_id,
                                           self._prompt_for(conv, turn_idx),
                                           sp, slo=self.default_slo,
                                           retain_kv=retain)
        except (EngineOverloadError, EngineDrainingError):
            # closed-world replay with admission control on: the trace
            # has no retry loop, so a refused submit is simply dropped
            # (counted by the core's ``rejected`` metric).  The default
            # config has no waiting bound, so replays are unaffected.
            self.dropped_submits += 1

    def _next_event_us(self) -> Optional[float]:
        events = [w.wake_s * 1e6 for w in self.sleeping]
        if self.pending:
            events.append(self.pending[0].arrival_s * 1e6)
        return min(events) if events else None

    # ------------------------------------------------------------------

    def step(self) -> List[RequestOutput]:
        core = self.core
        # arrivals, then wake-ups — same order the engine ran them when
        # they lived inside step()
        now_s = core.clock.now_us / 1e6
        while self.pending and self.pending[0].arrival_s <= now_s:
            self._submit(self.pending.pop(0), 0)
        for w in list(self.sleeping):
            if w.wake_s <= now_s:
                self.sleeping.remove(w)
                self._submit(w.conv, w.turn_idx)
        outs = core.step(until_us=self._next_event_us())
        for out in outs:
            if out.finished and out.finish_reason == "length":
                conv = self._convs[out.handle]
                if out.turn + 1 < len(conv.turns):
                    # think time counts from the FINISH instant
                    # (out.t_us), not the step's end — a later request's
                    # sync swap stall in the same iteration must not
                    # postpone this wake-up (replay parity)
                    self.sleeping.append(_Wake(
                        out.t_us / 1e6 + conv.think_time_s,
                        conv, out.turn + 1))
        return outs

    def done(self) -> bool:
        return (not self.pending and not self.sleeping
                and not self.core.sched.requests)

    def run(self, max_iterations: int = 2_000_000) -> EngineMetrics:
        it = 0
        while not self.done() and it < max_iterations:
            self.step()
            it += 1
        if self.core.runner is not None:
            self.core.runner.flush()
        self.core.swap.shutdown()
        return self.core.metrics
