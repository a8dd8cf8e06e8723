"""Deterministic fault injection + structured serving errors (DESIGN.md §7).

FastSwitch keeps tail latency bounded under *planned* churn (preemption,
swapping); production churn also includes *failures*: a swap transfer
that errors or stalls, a poison request whose forward pass raises, an
allocation-pressure spike that starves the pool.  This module provides
the chaos substrate the engine's containment layer is tested against:

  * ``FaultPlan`` — a frozen, seeded description of WHICH faults occur
    (rates per fault kind + explicit allocation-pressure windows).
  * ``FaultInjector`` — draws every decision as a pure function of
    ``(plan.seed, site key)`` via a stable hash, so a chaos schedule
    replays bit-exactly regardless of call order, thread timing or
    ``PYTHONHASHSEED``.  An injector built from ``plan=None`` is inert
    (``enabled`` is False and every hook is a cheap no-op).

Fault taxonomy (the degradation ladder in DESIGN.md §7 consumes these):

  swap transient   copy raises ``TransientSwapFault`` for the first
                   ``transient_failures`` attempts, then succeeds —
                   absorbed by the swap manager's bounded retry.
  swap permanent   copy raises ``PermanentSwapFault`` on every attempt —
                   retries exhaust; the engine escalates to a
                   recompute-mode resume (the KV is regenerated from the
                   token history, so the request survives).
  swap fatal       ``FatalSwapFault``: permanent AND marked
                   unrecoverable — the escalation ladder ends in a
                   request fault (``finish_reason="error"``).
  swap stall       the copy succeeds but its completion signal is stuck:
                   the task's ``done_at`` is pushed ``stall_us`` into the
                   simulated future.  The watchdog escalates it to a
                   synchronous retried copy.
  alloc pressure   ``reserved_blocks(iteration)`` > 0 inside a spike
                   window: the engine treats that many GPU blocks as
                   unavailable, forcing preemption/shedding churn.
  poison request   ``poisoned(handle)``: the request's prefill/emit path
                   raises ``PoisonError`` — contained to that request.

The structured overload errors (``EngineOverloadError``,
``EngineDrainingError``) live here too: they are the *admission-level*
half of graceful degradation (bounded waiting queue, drain mode).
"""
from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# structured errors
# ---------------------------------------------------------------------------


class InjectedFault(RuntimeError):
    """Base class for faults raised BY the injector (never by real code)."""


class TransientSwapFault(InjectedFault):
    """Swap copy failure that succeeds on retry."""


class PermanentSwapFault(InjectedFault):
    """Swap copy failure that exhausts every retry (recoverable by
    recompute-mode resume — the KV is regenerated from token history)."""


class FatalSwapFault(PermanentSwapFault):
    """Permanent swap failure marked unrecoverable: the escalation
    ladder must end in a request fault, not a recompute resume."""


class PoisonError(RuntimeError):
    """A poison request's compute path raised (stands in for a NaN
    blow-up, a malformed prompt crashing tokenization, etc.)."""


class EngineOverloadError(RuntimeError):
    """``add_request`` refused: the bounded waiting queue is full and the
    overload policy is ``"reject"`` (or the shed policy picked the new
    request itself).  Structured so a front-end can map it to HTTP 429
    with a meaningful retry hint."""

    def __init__(self, msg: str, *, queue_depth: int, max_waiting: int,
                 predicted_ttft_us: Optional[float] = None):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.max_waiting = max_waiting
        self.predicted_ttft_us = predicted_ttft_us


class EngineDrainingError(RuntimeError):
    """``add_request``/``continue_session`` refused: the engine is in
    drain mode (running requests finish; no new work is admitted)."""


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FaultPlan:
    """Seeded chaos schedule.  All probabilities are per *decision site*
    (a swap fault decision per dispatched chunk task, a poison decision
    per request handle); ``alloc_spikes`` are explicit windows
    ``(start_iteration, n_iterations, reserved_blocks)``."""
    seed: int = 0
    # swap-transfer fault mix (drawn once per chunk-task dispatch)
    p_swap_transient: float = 0.0
    p_swap_permanent: float = 0.0
    p_swap_fatal: float = 0.0
    p_swap_stall: float = 0.0
    stall_us: float = 200_000.0          # injected completion-signal delay
    transient_failures: int = 1          # failed attempts before success
    # per-request poison decision (drawn once per handle)
    p_poison: float = 0.0
    # allocation-pressure spikes: (start_iter, n_iters, blocks_reserved)
    alloc_spikes: Tuple[Tuple[int, int, int], ...] = ()

    @staticmethod
    def chaos(seed: int = 0, intensity: float = 1.0) -> "FaultPlan":
        """The default chaos mix (serve.py ``--chaos``): all fault kinds
        live at modest rates, two allocation-pressure windows."""
        s = min(max(intensity, 0.0), 4.0)
        return FaultPlan(
            seed=seed,
            p_swap_transient=0.15 * s, p_swap_permanent=0.05 * s,
            p_swap_fatal=0.01 * s, p_swap_stall=0.10 * s,
            p_poison=0.04 * s,
            alloc_spikes=((40, 25, 8), (140, 25, 16)))


@dataclass(frozen=True)
class SwapFaultSpec:
    """One chunk task's drawn fault: ``kind`` in {"transient",
    "permanent", "fatal"} or None (no copy fault), plus an independent
    stall draw."""
    kind: Optional[str] = None
    failures: int = 0                 # attempts that raise (transient)
    stall_us: float = 0.0


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------


def _site_rng(seed: int, *key) -> random.Random:
    """Deterministic per-site RNG: stable across processes and call
    order (``hash()`` on strings is randomized per process — use a real
    digest)."""
    h = hashlib.blake2b(repr((seed,) + key).encode(), digest_size=8)
    return random.Random(int.from_bytes(h.digest(), "big"))


class FaultInjector:
    """Answers "does a fault fire HERE?" purely from ``(seed, site)``.

    Sites are keyed by stable identifiers the engine already owns
    (request handle, swap direction, per-request dispatch sequence
    number, engine iteration), never by wall clock or object identity —
    that is what makes a chaos schedule replayable."""

    def __init__(self, plan: Optional[FaultPlan]):
        self.plan = plan
        self.enabled = plan is not None and (
            plan.p_swap_transient > 0 or plan.p_swap_permanent > 0
            or plan.p_swap_fatal > 0 or plan.p_swap_stall > 0
            or plan.p_poison > 0 or bool(plan.alloc_spikes))
        # observability: what actually fired (for tests / the event log)
        self.fired = {"transient": 0, "permanent": 0, "fatal": 0,
                      "stall": 0, "poison": 0}

    # -- swap-transfer faults ------------------------------------------

    def swap_fault(self, rid: int, direction: str,
                   seq: int) -> Optional[SwapFaultSpec]:
        """Drawn once per dispatched chunk task.  ``seq`` is the
        engine's per-(rid, direction) dispatch counter."""
        if not self.enabled:
            return None
        p = self.plan
        rng = _site_rng(p.seed, "swap", rid, direction, seq)
        u = rng.random()
        kind = None
        if u < p.p_swap_fatal:
            kind = "fatal"
        elif u < p.p_swap_fatal + p.p_swap_permanent:
            kind = "permanent"
        elif u < p.p_swap_fatal + p.p_swap_permanent + p.p_swap_transient:
            kind = "transient"
        stall = p.stall_us if rng.random() < p.p_swap_stall else 0.0
        if kind is None and stall == 0.0:
            return None
        if kind is not None:
            self.fired[kind] += 1
        if stall:
            self.fired["stall"] += 1
        return SwapFaultSpec(kind=kind,
                             failures=(p.transient_failures
                                       if kind == "transient" else 0),
                             stall_us=stall)

    @staticmethod
    def wrap_copy(spec: SwapFaultSpec, fn):
        """Wrap a data-plane copy so it raises per ``spec``.  The
        attempt counter lives in the closure: a transient fault fails
        the first ``spec.failures`` attempts then runs the real copy; a
        permanent/fatal fault raises on every attempt (the real copy
        never runs — the data genuinely does not arrive)."""
        attempts = [0]

        def wrapped():
            attempts[0] += 1
            if spec.kind == "fatal":
                raise FatalSwapFault(
                    f"injected fatal swap failure (attempt {attempts[0]})")
            if spec.kind == "permanent":
                raise PermanentSwapFault(
                    f"injected permanent swap failure "
                    f"(attempt {attempts[0]})")
            if spec.kind == "transient" and attempts[0] <= spec.failures:
                raise TransientSwapFault(
                    f"injected transient swap failure "
                    f"(attempt {attempts[0]}/{spec.failures})")
            if fn is not None:
                return fn()
            return None

        return wrapped

    # -- poison requests -----------------------------------------------

    def poisoned(self, rid: int) -> bool:
        """Pure per-handle decision: a poisoned request's compute path
        raises ``PoisonError`` at its first prefill chunk / first-token
        emission."""
        if not self.enabled or self.plan.p_poison <= 0:
            return False
        hit = _site_rng(self.plan.seed, "poison", rid).random() \
            < self.plan.p_poison
        return hit

    def note_poison_fired(self) -> None:
        self.fired["poison"] += 1

    # -- allocation pressure -------------------------------------------

    def reserved_blocks(self, iteration: int) -> int:
        """GPU blocks the engine must treat as unavailable during this
        iteration (the max over active spike windows)."""
        if not self.enabled:
            return 0
        r = 0
        for start, length, blocks in self.plan.alloc_spikes:
            if start <= iteration < start + length:
                r = max(r, blocks)
        return r
