"""Public serving-API types — the open-world request contract.

The ServingEngine (core/serving.py) speaks vLLM's proven request shape:
clients submit work with ``add_request(prompt, SamplingParams, slo)``,
drive the engine with ``step()`` and receive incremental
``RequestOutput`` deltas per iteration plus a ``RequestEvent`` stream
for observability.  Per-request SLO deadlines (``SLOSpec``) are folded
into per-turn attainment records (``RequestSLOStats``) — the
fairness-aware metric FastSwitch optimizes for (a tail percentile says
nothing about WHICH users missed; attainment accounting does, cf. the
VTC fairness line of work in PAPERS.md).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class SamplingParams:
    """Per-request generation parameters.

    ``max_tokens`` bounds the response.  ``stop_token_ids`` ends the
    turn early when a decoded token matches (``finish_reason="stop"``
    instead of ``"length"``); the stop token itself stays in the history
    and the streamed delta — truncation is presentation, the bit-exact
    token history is the engine's parity anchor.  Sim mode has no token
    ids, so stop sets are validated but can never fire there.
    ``temperature``/``top_k``/``top_p`` default to ``None`` = inherit
    the engine-wide sampling config; real mode fuses sampling into the
    batched decode step as a per-row traced ``(B, 3)`` array
    (DESIGN.md §3.6), so per-request overrides mix freely in one batch
    without adding a compiled variant — greedy rows stay bit-exact next
    to sampled rows (sim mode never samples, so values are validated
    but unused)."""
    max_tokens: int = 16
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    stop_token_ids: Tuple[int, ...] = ()


@dataclass(frozen=True)
class SLOSpec:
    """Per-request latency deadlines (``None`` = no deadline)."""
    ttft_ms: Optional[float] = None     # time-to-first-token deadline
    tbt_ms: Optional[float] = None      # per-token time-between-tokens

    @property
    def ttft_us(self) -> Optional[float]:
        return None if self.ttft_ms is None else self.ttft_ms * 1e3

    @property
    def tbt_us(self) -> Optional[float]:
        return None if self.tbt_ms is None else self.tbt_ms * 1e3


@dataclass
class RequestOutput:
    """One step's incremental result for one request (vLLM's
    ``RequestOutput`` shape).  ``new_tokens`` counts tokens credited
    this step (a request admitted AND decoded in the same iteration can
    emit 2); ``token_ids`` carries the actual ids only when the engine
    runs with ``stream_tokens`` (real mode — materializing ids costs the
    deferred-sync overlap, see DESIGN.md §6.2) — sim mode has no ids."""
    handle: int
    turn: int
    new_tokens: int = 0
    token_ids: Optional[List[int]] = None
    generated: int = 0                  # cumulative response tokens (turn)
    context_tokens: int = 0
    first_token: bool = False           # this step emitted the first token
    ttft_us: Optional[float] = None     # set when first_token
    finished: bool = False
    finish_reason: Optional[str] = None  # "length" | "stop" | "abort" |
    #                                      "dropped" | "error" | "shed"
    error: Optional[str] = None         # human-readable fault cause when
    #                                     finish_reason == "error"
    t_us: float = 0.0                   # engine clock at emission


@dataclass
class RequestEvent:
    """One lifecycle transition, for the per-request event log
    (JSONL-friendly: ``as_dict`` is flat and json-serializable)."""
    t_us: float
    handle: int
    kind: str        # arrive|continue|admit|resume|first_token|preempt|
    #                  swap_in|promote|finish|release|abort|drop|
    #                  error|shed|retry|drain|migrate_in|migrate_out
    data: Dict[str, object] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, object]:
        return {"t_us": self.t_us, "handle": self.handle,
                "kind": self.kind, **self.data}


EVENT_KINDS = frozenset({
    "arrive", "continue", "admit", "resume", "first_token", "preempt",
    "swap_in", "promote", "finish", "release", "abort", "drop",
    # robustness layer (DESIGN.md §7): request fault, overload shed,
    # swap-copy retry, engine drain toggle (drain uses handle -1 — it is
    # an engine-level event, not a request transition)
    "error", "shed", "retry", "drain",
    # cross-replica session migration (DESIGN.md §11): a parked session
    # leaves one replica's log with migrate_out and re-enters another's
    # with migrate_in — the pair is how the router's affinity audit
    # reconstructs ownership across engines
    "migrate_in", "migrate_out"})


@dataclass
class RequestSLOStats:
    """Per-turn SLO attainment record, folded into ``EngineMetrics``.

    ``ttft_ok`` / ``tbt_ok_frac`` are ``None`` when the request carried
    no deadline for that dimension (or never reached first token /
    second token)."""
    handle: int
    turn: int
    prompt_tokens: int
    generated: int
    ttft_us: Optional[float]
    mean_tbt_us: float
    max_tbt_us: float
    ttft_ok: Optional[bool]
    tbt_ok_frac: Optional[float]
    finish_reason: str

    @property
    def attained(self) -> Optional[bool]:
        """Fully attained = TTFT met and EVERY token met its TBT
        deadline; None when no deadline applied at all."""
        parts = [p for p in (self.ttft_ok,
                             None if self.tbt_ok_frac is None
                             else self.tbt_ok_frac >= 1.0)
                 if p is not None]
        return all(parts) if parts else None


def jain_index(xs: Sequence[float]) -> Optional[float]:
    """Jain's fairness index over per-request values: 1.0 = perfectly
    even, 1/n = maximally concentrated.  None for an empty input; an
    all-zero input is trivially even."""
    xs = list(xs)
    if not xs:
        return None
    sq = sum(x * x for x in xs)
    if sq == 0.0:
        return 1.0
    s = sum(xs)
    return (s * s) / (len(xs) * sq)
