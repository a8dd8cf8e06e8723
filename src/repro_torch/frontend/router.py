"""Session-affinity router over N engine replicas (DESIGN.md §11).

Pure decision logic — no threads, no sockets — so the asyncio server
and the deterministic ``DirectCluster`` driver share EXACTLY the same
routing behaviour (the loopback driver-equivalence test leans on this).

* **New sessions** go to the replica with the least predicted TTFT
  (each replica's ``ServingEngine.load_snapshot`` carries its admission
  queue model's prediction), with queue depth and index as
  deterministic tie-breaks.
* **Affinity**: a session's KV reuse copy lives on ONE replica, so
  every follow-up turn is pinned there — routing it anywhere else
  would silently re-prefill the whole context (and double the session's
  memory).  The affinity map is the single source of truth; the
  event-log auditor (``count_affinity_violations``) checks that no
  replica ever served a session it did not own.
* **Migration**: when load skews, PARKED sessions (turn finished,
  awaiting a follow-up) move hot -> cold via
  ``ServingEngine.export_session`` / ``import_session`` — the CPU reuse
  copy's bytes travel with the session, so the follow-up still pays
  only the prefix swap-in on its new home.  Live requests never move:
  their KV is on GPU and mid-flight; the router rebalances between
  turns.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class Router:
    def __init__(self, n_replicas: int, migrate_threshold: int = 4):
        assert n_replicas >= 1
        self.n_replicas = n_replicas
        # handle -> replica index owning the session's reuse copy
        self.affinity: Dict[int, int] = {}
        # load gap (queued+running requests) that triggers a rebalance
        self.migrate_threshold = migrate_threshold
        self.n_migrations = 0

    # -- dispatch ----------------------------------------------------------

    @staticmethod
    def _load(snap: Dict[str, object]) -> int:
        return int(snap["waiting"]) + int(snap["running"]) \
            + int(snap["swapped"]) + int(snap["swapping_in"])

    def route_new(self, handle: int,
                  snapshots: Sequence[Dict[str, object]]) -> int:
        """Least-predicted-TTFT dispatch for a fresh session; pins the
        handle's affinity.  Draining replicas are skipped (drain is the
        per-replica shutdown rung of the backpressure ladder)."""
        cands = [i for i, s in enumerate(snapshots) if not s["draining"]]
        if not cands:
            raise RuntimeError("all replicas draining")
        idx = min(cands, key=lambda i: (
            float(snapshots[i]["predicted_ttft_us"]),
            self._load(snapshots[i]), i))
        self.affinity[handle] = idx
        return idx

    def route_followup(self, handle: int) -> int:
        """Follow-up turns go where the session's KV lives — always."""
        return self.affinity[handle]

    def release(self, handle: int) -> None:
        self.affinity.pop(handle, None)

    def note_migrated(self, handle: int, dst: int) -> None:
        self.affinity[handle] = dst
        self.n_migrations += 1

    # -- rebalancing -------------------------------------------------------

    def plan_migrations(self, snapshots: Sequence[Dict[str, object]],
                        busy: Optional[Iterable[int]] = None
                        ) -> List[Tuple[int, int, int]]:
        """Plan parked-session moves (handle, src, dst) to close a load
        gap >= ``migrate_threshold`` between the hottest and coldest
        replica.  Only sessions parked on the hot replica move (its
        snapshot lists them), and only enough to halve the gap —
        rebalancing is damping, not oscillation.  ``busy`` handles
        (a follow-up mid-dispatch) are never planned."""
        if self.n_replicas < 2:
            return []
        loads = [self._load(s) for s in snapshots]
        hot = max(range(len(loads)), key=lambda i: (loads[i], i))
        cold = min(range(len(loads)), key=lambda i: (loads[i], -i))
        gap = loads[hot] - loads[cold]
        if hot == cold or gap < self.migrate_threshold \
                or snapshots[cold]["draining"]:
            return []
        skip = set(busy or ())
        movable = [h for h in snapshots[hot]["parked"]
                   if self.affinity.get(h) == hot and h not in skip]
        plans: List[Tuple[int, int, int]] = []
        for h in sorted(movable)[:max(1, gap // 2)]:
            plans.append((h, hot, cold))
        return plans


# ---------------------------------------------------------------------------
# event-log affinity audit
# ---------------------------------------------------------------------------

def count_affinity_violations(
        logs: Sequence[Sequence[Dict[str, object]]]) -> int:
    """Reconstruct session ownership from per-replica event logs and
    count violations — the acceptance gate's "zero cross-replica
    misroutes" check, computed from the logs alone (no trust in the
    router's own bookkeeping).

    Ownership discipline per replica log (each log is time-ordered on
    its own clock; replica clocks are not comparable, so the audit is
    per-log interval discipline plus global open/close pairing):

    * ``arrive`` / ``migrate_in`` open ownership of a handle.
    * ``migrate_out``, ``release``, a terminal ``abort``/``drop``/
      ``error``/``shed`` and a non-retained ``finish`` close it.
    * ANY other request event on a replica that does not currently own
      the handle is a violation (a follow-up or abort routed to the
      wrong replica shows up exactly like this).
    * Globally, a handle may be opened at most once more than it was
      handed off (``migrate_out``): two replicas claiming the same
      session is a violation even if each log is locally coherent.
    """
    violations = 0
    opens: Dict[int, int] = {}
    outs: Dict[int, int] = {}
    for events in logs:
        owned: set = set()
        for ev in events:
            h = int(ev["handle"])
            if h < 0:
                continue                      # engine-level (drain)
            kind = ev["kind"]
            if kind in ("arrive", "migrate_in"):
                if h in owned:
                    violations += 1           # double-open on one replica
                owned.add(h)
                opens[h] = opens.get(h, 0) + 1
            elif kind == "migrate_out":
                if h not in owned:
                    violations += 1
                owned.discard(h)
                outs[h] = outs.get(h, 0) + 1
            elif kind in ("release", "abort", "drop", "error", "shed"):
                if h not in owned:
                    violations += 1
                owned.discard(h)
            elif kind == "finish":
                if h not in owned:
                    violations += 1
                if not ev.get("retained", False):
                    owned.discard(h)
            else:
                if h not in owned:
                    violations += 1
    for h, n in opens.items():
        violations += max(0, n - 1 - outs.get(h, 0))
    return violations


def load_event_log(path: str) -> List[Dict[str, object]]:
    """Read one replica's JSONL event log (as written by the server's
    per-replica sink / ``launch.serve``'s ``--events``)."""
    out: List[Dict[str, object]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
