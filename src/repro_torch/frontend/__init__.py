"""Network front-end for multi-replica FastSwitch serving (DESIGN.md §11),
the port's counterpart of ``repro/frontend/``.

The first layer where fairness is enforced ACROSS engines rather than
inside one:

* ``admission``  — virtual-token-counter fair queue (arxiv 2401.00588)
  and the SLO-tightness -> scheduler-priority map (Equinox,
  arxiv 2508.16646): deadlines drive preemption.
* ``router``     — session-affinity routing over N replicas with
  least-predicted-TTFT dispatch and a parked-session migration planner;
  plus the event-log affinity auditor.
* ``server``     — asyncio streaming server (stdlib only) owning one
  ``ServingEngine`` per replica, each on a dedicated step-loop thread.
* ``loadgen``    — production-shaped load (diurnal rates, burst storms,
  heavy-tail sessions) and the deterministic ``DirectCluster`` driver
  behind ``BENCH_frontend.json``.

``admission`` and ``router`` are framework-free copies of the
reference's modules; ``server`` and ``loadgen`` drive the port's engine.
"""
from repro_torch.frontend.admission import (FairAdmissionQueue,
                                            QueueFullError, slo_priority)
from repro_torch.frontend.router import Router, count_affinity_violations

__all__ = [
    "FairAdmissionQueue", "QueueFullError", "slo_priority",
    "Router", "count_affinity_violations",
]
