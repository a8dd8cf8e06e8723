"""Production-shaped load generator + multi-replica fairness bench (the
port's counterpart of ``repro/frontend/loadgen.py``).

  PYTHONPATH=src python -m repro_torch.frontend.loadgen           # bench
  PYTHONPATH=src python -m repro_torch.frontend.loadgen --smoke   # loopback

Three pieces:

* ``storm_workload`` — arrivals shaped like a real serving day instead
  of a flat Poisson stream: a diurnal sinusoid rate, superimposed burst
  storms (a surge of near-simultaneous sessions — the shared-prefix
  stampede a prefix cache loves and a fair scheduler hates), and a
  heavy-tailed "whale" client whose Pareto session lengths would eat
  the cluster without VTC admission.
* ``DirectCluster`` — a deterministic, single-threaded N-replica driver
  that reuses the EXACT router + fair-queue decision code the asyncio
  server runs (``repro_torch.frontend.router`` / ``.admission``), stepping
  whichever engine's virtual clock is furthest behind.  No threads, no
  wall clock: the same seed gives the same ``BENCH_frontend.json``
  byte-for-byte.
* ``--smoke`` — boots the REAL network path for CI: a loopback
  ``FrontendServer`` over two sim replicas, a handful of socket
  clients (submit / stream / follow-up / abort), a clean ``drain``,
  then per-replica event-log validation and the affinity audit.
  ``run_smoke(..., make_engines=...)`` drives the same clients over
  other replicas (real mode on the CPU or the card): those get token ids
  (``synth_prompt_ids``) where the sim clients send token counts.

Bench acceptance: on the storm workload, 2 routed replicas
must show per-client Jain fairness >= the single overloaded replica,
with ZERO affinity violations in the merged event logs.
"""
from __future__ import annotations

import argparse
import asyncio
import heapq
import json
import math
import os
import random
import tempfile
from typing import Dict, List, Optional, Tuple

from repro_torch.core.faults import EngineOverloadError
from repro_torch.core.policies import EngineConfig
from repro_torch.core.request_api import SamplingParams, SLOSpec, jain_index
from repro_torch.core.serving import ServingEngine
from repro_torch.data.sharegpt import Conversation, Turn, synth_prompt_ids
from repro_torch.frontend.admission import FairAdmissionQueue, slo_priority
from repro_torch.frontend.router import Router, count_affinity_violations


# ---------------------------------------------------------------------------
# workload
# ---------------------------------------------------------------------------

# SLO tiers (sim-time ms).  "interactive" is tight enough that an
# overloaded replica misses it for queued requests; "batch" is loose
# enough that only pathological queueing misses it — the spread is what
# makes per-client attainment informative (an all-zero or all-one
# attainment vector makes Jain trivially 1.0).
SLO_TIERS = {
    "interactive": SLOSpec(ttft_ms=60.0, tbt_ms=55.0),
    "standard": SLOSpec(ttft_ms=300.0, tbt_ms=90.0),
    "batch": SLOSpec(ttft_ms=3000.0, tbt_ms=300.0),
}


def _client_tier(i: int) -> str:
    return ("interactive", "standard", "batch")[i % 3]


def storm_workload(*, n_clients: int = 6, duration_s: float = 60.0,
                   base_rate: float = 3.5, diurnal_amp: float = 0.6,
                   diurnal_period_s: float = 40.0, storms: int = 2,
                   storm_size: int = 20, storm_span_s: float = 1.0,
                   seed: int = 0
                   ) -> List[Tuple[float, str, Conversation, SLOSpec]]:
    """Build (arrival_s, client, conversation, slo) tuples.

    Clients 0..n-2 are "normal" (lognormal-ish lengths, SLO tier by
    index); the LAST client is the whale: rarer arrivals but Pareto
    heavy-tail response lengths and long multi-turn sessions."""
    rng = random.Random(seed)
    whale = f"client{n_clients - 1}"
    work: List[Tuple[float, str, Conversation, SLOSpec]] = []
    cid = 0

    def normal_conv(t: float) -> Conversation:
        nonlocal cid
        k = 1 + _geom(rng, 0.45)
        turns = [Turn(prompt_tokens=rng.randint(16, 96),
                      response_tokens=rng.randint(8, 48))
                 for _ in range(min(k, 4))]
        c = Conversation(conv_id=cid, arrival_s=t, turns=turns,
                         think_time_s=max(0.2, rng.gauss(1.5, 0.5)))
        cid += 1
        return c

    # diurnal Poisson stream (thinning against the peak rate)
    lam_max = base_rate * (1.0 + diurnal_amp)
    t = 0.0
    while True:
        t += rng.expovariate(lam_max)
        if t >= duration_s:
            break
        lam = base_rate * (1.0 + diurnal_amp
                           * math.sin(2.0 * math.pi * t / diurnal_period_s))
        if rng.random() * lam_max > lam:
            continue
        client = f"client{rng.randrange(n_clients - 1)}"
        work.append((t, client, normal_conv(t),
                     SLO_TIERS[_client_tier(int(client[6:]))]))

    # burst storms: storm_size sessions landing within storm_span_s,
    # all opening with the SAME long prompt length (the shared-prefix
    # stampede shape; real-mode ids would share a cacheable prefix)
    for s in range(storms):
        t0 = (s + 0.5) * duration_s / storms
        shared_prompt = 64 + 32 * s
        for _ in range(storm_size):
            ts = t0 + rng.random() * storm_span_s
            client = f"client{rng.randrange(n_clients - 1)}"
            turns = [Turn(prompt_tokens=shared_prompt,
                          response_tokens=rng.randint(8, 32))]
            work.append((ts, client,
                         Conversation(conv_id=cid, arrival_s=ts, turns=turns,
                                      think_time_s=1.0),
                         SLO_TIERS[_client_tier(int(client[6:]))]))
            cid += 1

    # the whale: few sessions, Pareto heavy-tail responses, many turns
    tw = rng.uniform(0.0, duration_s / 4)
    while tw < duration_s:
        turns = []
        for _ in range(rng.randint(3, 6)):
            rt = int(min(384, 24 * rng.paretovariate(1.3)))
            turns.append(Turn(prompt_tokens=rng.randint(32, 128),
                              response_tokens=max(8, rt)))
        work.append((tw, whale,
                     Conversation(conv_id=cid, arrival_s=tw, turns=turns,
                                  think_time_s=0.5),
                     SLO_TIERS["standard"]))
        cid += 1
        tw += rng.expovariate(0.15)
    work.sort(key=lambda w: (w[0], w[2].conv_id))
    return work


def _geom(rng: random.Random, p: float) -> int:
    u = rng.random()
    return int(math.floor(math.log(max(u, 1e-12)) / math.log(max(1 - p, 1e-12))))


# ---------------------------------------------------------------------------
# deterministic multi-replica driver
# ---------------------------------------------------------------------------

def sim_engine_config(*, gpu_blocks: int = 160, cpu_blocks: int = 640,
                      max_running: int = 8) -> EngineConfig:
    """One replica of the bench cluster: small enough that the storm
    workload genuinely overloads a single replica (the 1-vs-2 Jain
    comparison needs contention), bounded waiting queue so backlog
    lives in the FAIR queue, not the engine's FIFO."""
    return EngineConfig(
        mode="sim", num_gpu_blocks=gpu_blocks, num_cpu_blocks=cpu_blocks,
        max_running=max_running, max_waiting=2 * max_running,
        overload_policy="reject",
    ).with_policy("fastswitch")


class DirectCluster:
    """Single-threaded virtual-time driver over N sim engines, sharing
    the server's Router + FairAdmissionQueue decision code.  Always
    steps the busy engine whose clock is furthest behind; idle engines
    fast-forward (``step(until_us=...)``) to the event that wakes them,
    so each replica's timeline stays coherent without any global
    clock."""

    def __init__(self, n_replicas: int, *,
                 config: Optional[EngineConfig] = None,
                 migrate_threshold: int = 6, rebalance_every: int = 16):
        cfg = config or sim_engine_config()
        self.engines = [ServingEngine(cfg) for _ in range(n_replicas)]
        self.router = Router(n_replicas, migrate_threshold=migrate_threshold)
        self.queue = FairAdmissionQueue(capacity=0)
        self.rebalance_every = rebalance_every
        self.sessions: Dict[int, Dict[str, object]] = {}
        self.client_of: Dict[int, str] = {}
        self._events: List[Tuple[float, int, str, int]] = []   # heap
        self._seq = 0
        self._next_handle = 0
        self._pending: List[Tuple[float, str, Conversation, SLOSpec]] = []

    # -- event plumbing ----------------------------------------------------

    def _push_event(self, t_us: float, kind: str, ref: int) -> None:
        heapq.heappush(self._events, (t_us, self._seq, kind, ref))
        self._seq += 1

    def _snapshots(self) -> List[Dict[str, object]]:
        return [e.load_snapshot() for e in self.engines]

    def _advance_to(self, idx: int, t_us: float) -> None:
        """Fast-forward an IDLE engine's clock to ``t_us`` (an engine
        with work earns its time by stepping)."""
        e = self.engines[idx]
        while not e.has_work() and e.clock.now_us < t_us:
            e.step(until_us=t_us)

    # -- arrivals / turns --------------------------------------------------

    def _fire(self, t_us: float, kind: str, ref: int) -> None:
        if kind == "arrive":
            t, client, conv, slo = self._pending[ref]
            handle = self._next_handle
            self._next_handle += 1
            self.sessions[handle] = {
                "client": client, "conv": conv, "turn": 0, "slo": slo,
            }
            self.client_of[handle] = client
            self.queue.push(client, handle)
        elif kind == "continue":
            handle = ref
            sess = self.sessions[handle]
            idx = self.router.route_followup(handle)
            self._advance_to(idx, t_us)
            conv: Conversation = sess["conv"]          # type: ignore
            tix = int(sess["turn"]) + 1                # type: ignore
            sess["turn"] = tix
            turn = conv.turns[tix]
            slo: SLOSpec = sess["slo"]                 # type: ignore
            self.engines[idx].continue_session(
                handle, turn.prompt_tokens,
                SamplingParams(max_tokens=turn.response_tokens), slo=slo,
                retain_kv=(tix + 1 < len(conv.turns)),
                priority=slo_priority(slo))
            self.queue.begin(sess["client"])           # type: ignore
            self.queue.charge(sess["client"], turn.prompt_tokens)

    def _dispatch(self) -> None:
        """Drain the fair queue in VTC order until an engine pushes
        back; a refused dispatch requeues at the front, uncharged."""
        while True:
            popped = self.queue.pop()
            if popped is None:
                return
            client, handle = popped
            sess = self.sessions[handle]
            snaps = self._snapshots()
            idx = self.router.route_new(handle, snaps)
            conv: Conversation = sess["conv"]          # type: ignore
            turn = conv.turns[0]
            slo: SLOSpec = sess["slo"]                 # type: ignore
            # the arrival reaches the replica "now" on its own timeline;
            # an idle replica first catches up to the busiest clock so
            # its latency accounting shares the cluster's notion of now
            tref = max((e.clock.now_us for e in self.engines
                        if e.has_work()), default=0.0)
            self._advance_to(idx, tref)
            try:
                self.engines[idx].add_request(
                    turn.prompt_tokens,
                    SamplingParams(max_tokens=turn.response_tokens),
                    slo=slo, handle=handle,
                    retain_kv=(len(conv.turns) > 1),
                    priority=slo_priority(slo))
            except EngineOverloadError:
                self.router.release(handle)
                self.queue.requeue(client, handle)
                return
            self.queue.charge(client, turn.prompt_tokens)

    def _consume(self, idx: int, outs) -> None:
        for out in outs:
            sess = self.sessions.get(out.handle)
            if sess is None:
                continue
            client = sess["client"]                    # type: ignore
            if out.new_tokens > 0:
                self.queue.feedback(client, out.new_tokens)
            if out.finished:
                self.queue.done(client)
                conv: Conversation = sess["conv"]      # type: ignore
                tix = int(sess["turn"])                # type: ignore
                more = (out.finish_reason in ("length", "stop")
                        and tix + 1 < len(conv.turns))
                if more:
                    wake = self.engines[idx].clock.now_us \
                        + conv.think_time_s * 1e6
                    self._push_event(wake, "continue", out.handle)
                else:
                    self.router.release(out.handle)
                    del self.sessions[out.handle]

    def _rebalance(self) -> None:
        snaps = self._snapshots()
        for handle, src, dst in self.router.plan_migrations(snaps):
            try:
                payload = self.engines[src].export_session(handle)
            except KeyError:
                continue
            self.engines[dst].import_session(payload)
            self.router.note_migrated(handle, dst)

    # -- the run loop ------------------------------------------------------

    def run(self, workload: List[Tuple[float, str, Conversation, SLOSpec]]
            ) -> None:
        self._pending = list(workload)
        for i, (t, _c, _conv, _slo) in enumerate(self._pending):
            self._push_event(t * 1e6, "arrive", i)
        iters = 0
        while True:
            busy = [i for i, e in enumerate(self.engines) if e.has_work()]
            if busy:
                now = min(self.engines[i].clock.now_us for i in busy)
                while self._events and self._events[0][0] <= now:
                    t_us, _s, kind, ref = heapq.heappop(self._events)
                    self._fire(t_us, kind, ref)
                self._dispatch()
                busy = [i for i, e in enumerate(self.engines)
                        if e.has_work()]
                if busy:
                    idx = min(busy,
                              key=lambda i: self.engines[i].clock.now_us)
                    nxt = self._events[0][0] if self._events else None
                    outs = self.engines[idx].step(until_us=nxt)
                    self._consume(idx, outs)
                iters += 1
                if iters % self.rebalance_every == 0:
                    self._rebalance()
            elif self._events:
                t_us, _s, kind, ref = heapq.heappop(self._events)
                self._fire(t_us, kind, ref)
                self._dispatch()
            elif self.queue.depth() > 0:
                self._dispatch()
            else:
                break

    # -- results -----------------------------------------------------------

    def results(self) -> Dict[str, object]:
        per_client_scores: Dict[str, List[float]] = {}
        per_client_ttft: Dict[str, List[float]] = {}
        per_client_maxtbt: Dict[str, List[float]] = {}
        for e in self.engines:
            for st in e.metrics.request_stats:
                client = self.client_of.get(st.handle)
                if client is None:
                    continue
                parts = []
                if st.ttft_ok is not None:
                    parts.append(1.0 if st.ttft_ok else 0.0)
                if st.tbt_ok_frac is not None:
                    parts.append(float(st.tbt_ok_frac))
                if parts:
                    per_client_scores.setdefault(client, []).append(
                        sum(parts) / len(parts))
                if st.ttft_us is not None:
                    per_client_ttft.setdefault(client, []).append(st.ttft_us)
                per_client_maxtbt.setdefault(client, []).append(st.max_tbt_us)
        attain = {c: sum(v) / len(v)
                  for c, v in sorted(per_client_scores.items())}
        logs = [[ev.as_dict() for ev in e.events] for e in self.engines]
        return {
            "replicas": len(self.engines),
            "per_client_attainment": attain,
            "jain_attainment": jain_index(list(attain.values())),
            "per_client_p95_ttft_ms": {
                c: _p95(v) / 1e3 for c, v in sorted(per_client_ttft.items())},
            "per_client_p95_max_tbt_ms": {
                c: _p95(v) / 1e3
                for c, v in sorted(per_client_maxtbt.items())},
            "turns_finished": sum(len(e.metrics.request_stats)
                                  for e in self.engines),
            "migrations": self.router.n_migrations,
            "affinity_violations": count_affinity_violations(logs),
        }


def _p95(xs: List[float]) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(math.ceil(0.95 * len(ys))) - 1)]


# ---------------------------------------------------------------------------
# bench: 1 replica vs 2 routed replicas on the same storm
# ---------------------------------------------------------------------------

def run_bench(seed: int = 0, duration_s: float = 60.0) -> Dict[str, object]:
    rows = []
    for n in (1, 2):
        work = storm_workload(seed=seed, duration_s=duration_s)
        cluster = DirectCluster(n)
        cluster.run(work)
        rows.append(cluster.results())
    return {
        "bench": "frontend_storm",
        "seed": seed,
        "duration_s": duration_s,
        "workload": {"sessions": len(storm_workload(seed=seed,
                                                    duration_s=duration_s))},
        "rows": rows,
        "jain_gain": (rows[1]["jain_attainment"] or 0.0)
        - (rows[0]["jain_attainment"] or 0.0),
    }


# ---------------------------------------------------------------------------
# --smoke: the real network path on loopback (CI gate)
# ---------------------------------------------------------------------------

async def _smoke_client(host: str, port: int, name: str, prompts: List,
                        *, follow_up: bool = True, abort_one: bool = False,
                        follow_prompt=12) -> Dict[str, object]:
    """One socket client: submit every prompt (a token count for sim
    replicas, a token-id list for real ones), stream until each turn
    finishes, follow up once on the first retained session with
    ``follow_prompt`` (so that handle finishes TWICE), release every
    retained session, abort one mid-flight when asked.  Returns the
    finish reasons seen and, per handle, its turns: the prompt sent, the
    token ids streamed and the finish reason."""
    reader, writer = await asyncio.open_connection(host, port)
    for i, p in enumerate(prompts):
        # the request that will be aborted gets a huge budget so the
        # abort reliably lands while it is still decoding
        req = {"op": "submit", "id": f"{name}/{i}", "client": name,
               "prompt": p,
               "max_tokens": 512 if (abort_one and i == 0) else 8,
               "slo": {"ttft_ms": 5000.0, "tbt_ms": 500.0}}
        writer.write(json.dumps(req).encode() + b"\n")
    await writer.drain()
    reasons: List[str] = []
    handles: List[int] = []
    turns: Dict[int, List[Dict[str, object]]] = {}

    def turn(h: int) -> Dict[str, object]:
        return turns.setdefault(h, [{"prompt": None, "tokens": []}])[-1]
    continued: Optional[int] = None
    aborted: Optional[int] = None
    expected = len(prompts)
    n_finish = 0
    while n_finish < expected:
        line = await reader.readline()
        if not line:
            break
        ev = json.loads(line)
        if ev.get("event") == "accepted":
            h = ev["handle"]
            if h not in handles:
                handles.append(h)
                turn(h)["prompt"] = prompts[int(ev["id"].split("/")[1])]
                if abort_one and aborted is None \
                        and ev.get("id") == f"{name}/0":
                    aborted = h
                    writer.write(json.dumps(
                        {"op": "abort", "handle": h}).encode() + b"\n")
                    await writer.drain()
        elif ev.get("event") == "token":
            turn(ev["handle"])["tokens"].extend(ev.get("token_ids") or [])
        elif ev.get("event") == "finish":
            h = ev["handle"]
            n_finish += 1
            reasons.append(ev["reason"])
            turn(h)["reason"] = ev["reason"]
            if ev.get("retained"):
                if follow_up and continued is None:
                    # one follow-up turn through the affinity-pinned
                    # replica; the handle finishes a second time
                    continued = h
                    expected += 1
                    turns[h].append({"prompt": follow_prompt, "tokens": []})
                    writer.write(json.dumps(
                        {"op": "continue", "handle": h,
                         "prompt": follow_prompt,
                         "max_tokens": 6}).encode() + b"\n")
                else:
                    writer.write(json.dumps(
                        {"op": "release", "handle": h}).encode() + b"\n")
                await writer.drain()
        elif ev.get("event") == "error":
            raise AssertionError(f"{name}: server error {ev}")
    writer.close()
    await writer.wait_closed()
    return {"name": name, "reasons": reasons, "aborted": aborted,
            "continued": continued, "turns": turns}


# the smoke's clients: (name, prompt lengths, client options)
SMOKE_CLIENTS = (("alice", (24, 40, 16), {}),
                 ("bob", (32, 20), {"abort_one": True}),
                 ("carol", (48,), {"follow_up": True}))


def smoke_engines(mk_sink, n_replicas: int = 2) -> List[ServingEngine]:
    """The smoke's sim replicas, replica i logging to ``mk_sink(i)``."""
    cfg = EngineConfig(mode="sim", num_gpu_blocks=256, num_cpu_blocks=1024,
                       max_running=8).with_policy("fastswitch")
    return [ServingEngine(cfg, event_sink=mk_sink(i))
            for i in range(n_replicas)]


async def _smoke_async(events_prefix: str, make_engines=None, vocab=None,
                       after=None) -> Dict[str, object]:
    """The loopback smoke over ``make_engines(mk_sink)``'s replicas
    (default ``smoke_engines``: two sim replicas); replica i's event sink
    ``mk_sink(i)`` writes ``events_prefix``_r<i>.jsonl.  ``vocab``: send
    token ids drawn below it instead of token counts.  ``after(srv)``, a
    coroutine function, runs once the clients finish, before the drain;
    its result is returned under ``after``."""
    from repro_torch.frontend.server import FrontendServer

    files: Dict[int, object] = {}

    def mk_sink(i: int):
        f = files[i] = open(f"{events_prefix}_r{i}.jsonl", "w")

        def sink(ev):
            f.write(json.dumps(ev.as_dict()) + "\n")
        return sink
    engines = (make_engines or smoke_engines)(mk_sink)

    def prompt(seed: int, turn: int, n: int):
        return n if vocab is None else synth_prompt_ids(seed, turn, n, vocab)

    srv = FrontendServer(engines, admission_capacity=64)
    host, port = await srv.start()
    extra = None
    try:
        results = await asyncio.gather(*[
            _smoke_client(host, port, name,
                          [prompt(100 * c + i, 0, n)
                           for i, n in enumerate(lens)],
                          follow_prompt=prompt(100 * c, 1, 12), **kw)
            for c, (name, lens, kw) in enumerate(SMOKE_CLIENTS)])
        if after is not None:
            extra = await after(srv)
        # clean drain: no new work admitted, in-flight finishes, server
        # acknowledges when every replica is empty
        reader, writer = await asyncio.open_connection(host, port)
        writer.write(b'{"op": "drain"}\n')
        await writer.drain()
        line = await reader.readline()
        assert json.loads(line).get("event") == "drained", line
        writer.write(b'{"op": "submit", "id": "late", "prompt": 8}\n')
        await writer.drain()
        refusal = json.loads(await reader.readline())
        assert refusal.get("code") == 503, refusal
        writer.close()
        await writer.wait_closed()
    finally:
        await srv.close()
        for f in files.values():
            f.close()
    return {"clients": results, "after": extra,
            "paths": [f"{events_prefix}_r{i}.jsonl" for i in sorted(files)]}


def run_smoke(events_prefix: str, make_engines=None, vocab=None,
              after=None) -> Dict[str, object]:
    """Run the loopback smoke (``_smoke_async``) and check it: every
    replica's event log well-formed, no affinity violation, an abort, a
    finish by length and a follow-up seen."""
    out = asyncio.run(_smoke_async(events_prefix, make_engines, vocab,
                                   after))
    from repro_torch.frontend.router import load_event_log
    from repro_torch.launch.serve import validate_event_log

    logs = []
    for path in out["paths"]:
        validate_event_log(path)
        logs.append(load_event_log(path))
    violations = count_affinity_violations(logs)
    assert violations == 0, f"{violations} affinity violations"
    reasons = [r for c in out["clients"] for r in c["reasons"]]
    assert "abort" in reasons and "length" in reasons, reasons
    assert any(c["continued"] is not None for c in out["clients"])
    return {
        "bench": "frontend_smoke", "replicas": len(logs),
        "turns_finished": len(reasons), "affinity_violations": violations,
        "events_validated": out["paths"], "clients": out["clients"],
        "after": out["after"],
    }


# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="loopback server smoke (CI): 2 sim replicas, "
                         "socket clients, clean drain, event-log audit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--duration", type=float, default=60.0,
                    help="storm workload length (virtual seconds)")
    ap.add_argument("--events-prefix",
                    default=os.path.join(tempfile.gettempdir(),
                                         "fastswitch_online_frontend"),
                    help="per-replica event-log path prefix (smoke mode)")
    ap.add_argument("--json-out", default=None,
                    help="write results to this path")
    args = ap.parse_args(argv)

    if args.smoke:
        res = run_smoke(args.events_prefix)
        # the streams and hooks are for in-process callers
        res.pop("clients")
        res.pop("after")
    else:
        res = run_bench(seed=args.seed, duration_s=args.duration)
    text = json.dumps(res, indent=2, sort_keys=True)
    print(text)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
