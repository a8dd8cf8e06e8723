"""Fair admission — the virtual-token-counter queue and the SLO map.

Two ideas from the fairness line of work (PAPERS.md) meet here:

* **VTC fair queueing** (Fairness in Serving LLMs, arxiv 2401.00588):
  each client carries a virtual *service counter* — tokens served,
  weighted by its share.  Dispatch always picks the backlogged client
  with the LOWEST normalized counter, so a client streaming one long
  session cannot starve ten clients sending short ones.  A client that
  (re)activates after idling has its counter LIFTED to the minimum over
  the active set: idling banks no credit (the "no free lunch for
  sleeping" rule the paper's U-bound proof needs).  With per-dispatch
  charges bounded by ``U`` tokens, any two continuously backlogged
  clients' normalized counters stay within ``2 * U`` of each other —
  the property ``tests/test_frontend.py`` checks.

* **SLO tightness -> scheduler priority** (Equinox, arxiv 2508.16646):
  deadlines should DRIVE preemption, not just be measured after the
  fact.  ``slo_priority`` maps a request's effective deadline onto the
  engine's priority scale (higher = more important, see
  ``PriorityScheduler``), and the front-end passes it through the
  ``add_request(priority=...)`` override — so a tight-TTFT request
  preempts a loose batch job instead of queueing behind it.

The queue is thread-safe (the asyncio loop and N replica threads all
touch it) and holds opaque items: the server queues tickets, the
DirectCluster driver queues conversations.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple


class QueueFullError(Exception):
    """Admission queue at capacity — the 429 rung of the backpressure
    ladder (DESIGN.md §11): refuse at the door, before any per-request
    state exists."""

    def __init__(self, msg: str, queue_depth: int = 0, capacity: int = 0):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.capacity = capacity


def slo_priority(slo) -> float:
    """Map SLO tightness onto scheduler priority (Equinox): monotone
    decreasing in the effective deadline, so tighter deadlines preempt
    looser ones.  The effective deadline is the binding constraint —
    the TTFT deadline, or the TBT deadline scaled by a nominal response
    length (a 40 ms TBT budget binds like a ~1 s completion deadline).
    Requests without any SLO sit at a low floor: they yield to every
    deadline-carrying request but still order among themselves via
    arrival.  Range (0, 1] — deliberately inside the priority traces'
    scale so overrides and trace priorities compose."""
    if slo is None or (slo.ttft_ms is None and slo.tbt_ms is None):
        return 0.25
    parts = []
    if slo.ttft_ms is not None:
        parts.append(float(slo.ttft_ms))
    if slo.tbt_ms is not None:
        parts.append(float(slo.tbt_ms) * 25.0)
    d = min(parts)
    return 1.0 / (1.0 + d / 1000.0)


class FairAdmissionQueue:
    """Weighted VTC fair queue over per-client FIFO lanes.

    Charging protocol (the server/cluster drivers follow it):
      * ``pop`` picks the next (client, item) to DISPATCH — it does not
        charge.
      * ``charge(client, prompt_tokens)`` on SUCCESSFUL engine submit
        (a dispatch refused by an overloaded engine is ``requeue``d
        uncharged — otherwise a refusal would bill the client twice).
      * ``feedback(client, n)`` as decode tokens stream out, so a long
        generation keeps paying while it runs.
    """

    def __init__(self, capacity: int = 0,
                 weights: Optional[Dict[str, float]] = None):
        self._lock = threading.Lock()
        self.capacity = capacity            # 0 = unbounded
        self.weights: Dict[str, float] = dict(weights or {})
        self.counters: Dict[str, float] = {}
        self._lanes: Dict[str, Deque[object]] = {}
        self._inflight: Dict[str, int] = {}
        self._depth = 0

    # -- introspection -----------------------------------------------------

    def weight(self, client: str) -> float:
        return self.weights.get(client, 1.0)

    def depth(self) -> int:
        with self._lock:
            return self._depth

    def backlogged(self) -> List[str]:
        with self._lock:
            return [c for c, q in self._lanes.items() if q]

    def norm_counter(self, client: str) -> float:
        with self._lock:
            return self.counters.get(client, 0.0) / self.weight(client)

    # -- the queue ---------------------------------------------------------

    def _active_min(self) -> float:
        """Minimum normalized counter over ACTIVE clients (backlogged or
        with dispatched work still in flight) — the lift target for a
        (re)activating client."""
        vals = [self.counters[c] / self.weight(c)
                for c in self.counters
                if self._lanes.get(c) or self._inflight.get(c, 0)]
        return min(vals) if vals else 0.0

    def push(self, client: str, item: object) -> None:
        with self._lock:
            if self.capacity and self._depth >= self.capacity:
                raise QueueFullError(
                    f"admission queue full ({self._depth} >= "
                    f"capacity={self.capacity})",
                    queue_depth=self._depth, capacity=self.capacity)
            lane = self._lanes.setdefault(client, deque())
            if not lane and not self._inflight.get(client, 0):
                # (re)activation: lift to the active minimum so idle
                # time banks no credit (VTC's no-starvation invariant)
                lift = self._active_min() * self.weight(client)
                self.counters[client] = max(
                    self.counters.get(client, 0.0), lift)
            else:
                self.counters.setdefault(client, 0.0)
            lane.append(item)
            self._depth += 1

    def pop(self) -> Optional[Tuple[str, object]]:
        """Next (client, item) to dispatch: lowest normalized counter
        among backlogged clients, FIFO within the client's lane.  Marks
        the client in flight until ``done``/``requeue``."""
        with self._lock:
            cands = [c for c, q in self._lanes.items() if q]
            if not cands:
                return None
            client = min(cands, key=lambda c: (
                self.counters.get(c, 0.0) / self.weight(c), c))
            item = self._lanes[client].popleft()
            self._depth -= 1
            self._inflight[client] = self._inflight.get(client, 0) + 1
            return client, item

    def begin(self, client: str) -> None:
        """Mark one dispatched item in flight WITHOUT it having queued
        (follow-up turns skip the lanes — their KV is resident — but
        must still count as active so the client's counter is not
        lifted away and ``done`` balances)."""
        with self._lock:
            self.counters.setdefault(client, 0.0)
            self._inflight[client] = self._inflight.get(client, 0) + 1

    def requeue(self, client: str, item: object) -> None:
        """Put a refused dispatch BACK at the front of its lane,
        uncharged — the engine said 'not now' (overload), not 'never';
        the client keeps its queue position."""
        with self._lock:
            self._lanes.setdefault(client, deque()).appendleft(item)
            self._depth += 1
            n = self._inflight.get(client, 0) - 1
            if n > 0:
                self._inflight[client] = n
            elif client in self._inflight:
                del self._inflight[client]

    def charge(self, client: str, tokens: int) -> None:
        """Bill ``tokens`` of service against the client's counter
        (weighted).  Prompt tokens at successful dispatch; decode
        tokens through ``feedback`` as they stream."""
        with self._lock:
            self.counters[client] = self.counters.get(client, 0.0) \
                + float(max(tokens, 0))

    # decode-time billing is the same operation; the distinct name keeps
    # call sites honest about WHICH tokens they are charging
    feedback = charge

    def done(self, client: str) -> None:
        """A dispatched item finished (any terminal reason): the client
        leaves the in-flight set once its last item ends."""
        with self._lock:
            n = self._inflight.get(client, 0) - 1
            if n > 0:
                self._inflight[client] = n
            elif client in self._inflight:
                del self._inflight[client]

    def purge(self, pred: Callable[[str, object], bool]) -> int:
        """Drop queued items matching ``pred`` (a disconnected client's
        tickets).  Returns the number removed."""
        removed = 0
        with self._lock:
            for client, lane in self._lanes.items():
                kept = deque(i for i in lane if not pred(client, i))
                removed += len(lane) - len(kept)
                self._lanes[client] = kept
            self._depth -= removed
        return removed
