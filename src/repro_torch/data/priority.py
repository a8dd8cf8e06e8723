"""Context-switching (priority) trace simulation — paper §4.

Two offline patterns, priorities recomputed every 1/frequency iterations:
  * Random: i.i.d. priorities each update (uncontrolled environment);
  * Markov: temporal locality — recently served requests keep high
    priority with probability ``stickiness``, others random-walk.
"""
from __future__ import annotations

import random
from typing import Dict, Iterable


class PriorityTrace:
    def __init__(self, pattern: str = "markov", update_freq: float = 0.02,
                 seed: int = 0, stickiness: float = 0.8):
        assert pattern in ("random", "markov")
        self.pattern = pattern
        self.period = max(1, int(round(1.0 / update_freq)))
        self.rng = random.Random(seed)
        self.stickiness = stickiness
        self._prio: Dict[int, float] = {}
        self._iter = 0

    def priority(self, req_id: int) -> float:
        if req_id not in self._prio:
            self._prio[req_id] = self.rng.random()
        return self._prio[req_id]

    def step(self, active_ids: Iterable[int], running_ids: Iterable[int]
             ) -> bool:
        """Advance one iteration; returns True when priorities were updated
        this iteration (scheduler must re-balance)."""
        self._iter += 1
        if self._iter % self.period != 0:
            return False
        running = set(running_ids)
        for rid in active_ids:
            if self.pattern == "random":
                self._prio[rid] = self.rng.random()
            else:  # markov: temporal locality
                if rid in running and self.rng.random() < self.stickiness:
                    # recently served stays high
                    self._prio[rid] = 0.5 + 0.5 * self.rng.random()
                else:
                    base = self._prio.get(rid, self.rng.random())
                    self._prio[rid] = min(1.0, max(
                        0.0, base + self.rng.uniform(-0.35, 0.35)))
        return True
