"""The port's network front-end, ``repro_torch.frontend``, against the
reference's ``repro.frontend`` (CPU).

  * fair admission, the SLO map, the router and the event-log affinity
    audit: each case runs through both packages on the same seeded
    inputs and must give equal decisions (and the properties the
    reference's own tests state);
  * ``DirectCluster`` on the 8-s storm and the 60-s bench: the
    reference's results dict and rows (counts exact, floats to 1e-12),
    and ``BENCH_frontend.json``'s 536 turns, 98 migrations, 0 violations
    (the bench with the port's short-copy repair taken out; with it, the
    row that meets short copies keeps its counts);
  * real mode on the reduced model: the migration round trip is byte
    exact within the port, and the loopback server (sockets, fair queue,
    router, replica threads) streams the tokens a direct engine makes;
  * the server's own repairs: one finish per aborted turn, a 400 (not a
    dead dispatcher) for a request the engine refuses, and a shutdown
    that does not wait on connected clients;
  * ``python -m repro_torch.frontend.loadgen --smoke`` passes.

Real-mode runs compared exactly hold their swap tasks to the simulated
clock (``swaps_follow_the_clock``, see ``tests/test_torch_serve.py``).
"""
import asyncio
import json
import math
import os
import random
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from repro.frontend import admission as jax_admission
from repro.frontend import loadgen as jax_loadgen
from repro.frontend import router as jax_router
from repro_torch.configs import get_smoke_config
from repro_torch.core import EngineConfig, SamplingParams, ServingEngine
from repro_torch.core.request_api import SLOSpec
from repro_torch.data.sharegpt import synth_prompt_ids
from repro_torch.frontend import admission, loadgen, router
from repro_torch.models import transformer as T
from test_torch_serve import swaps_follow_the_clock  # noqa: F401
from torch_threads import one_torch_thread  # noqa: E402,F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PACKAGES = {
    "reference": types.SimpleNamespace(adm=jax_admission, rt=jax_router),
    "port": types.SimpleNamespace(adm=admission, rt=router),
}


# ---------------------------------------------------------------------------
# decisions through both packages
# ---------------------------------------------------------------------------


def case_slo_priority(m):
    """The SLO -> priority map over a grid of deadlines, and its order."""
    slos = [None, SLOSpec(ttft_ms=None, tbt_ms=None)] + [
        SLOSpec(ttft_ms=t, tbt_ms=b) for t in (None, 50.0, 300.0, 3000.0)
        for b in (None, 40.0, 90.0, 300.0, 400.0)]
    p = [m.adm.slo_priority(s) for s in slos]
    tight, mid, loose = (m.adm.slo_priority(SLOSpec(ttft_ms=t, tbt_ms=b))
                         for t, b in ((50.0, 40.0), (300.0, 90.0),
                                      (3000.0, 300.0)))
    assert tight > mid > loose and 0.0 < p[0] == p[1] < tight <= 1.0
    return p


def case_capacity_refusal(m):
    q = m.adm.FairAdmissionQueue(capacity=2)
    q.push("a", 1)
    q.push("b", 2)
    with pytest.raises(m.adm.QueueFullError) as ei:
        q.push("a", 3)
    assert ei.value.queue_depth == 2 and ei.value.capacity == 2
    return [q.depth(), ei.value.queue_depth, str(ei.value)]


def case_requeue_front_uncharged(m):
    q = m.adm.FairAdmissionQueue()
    q.push("a", "first")
    q.push("a", "second")
    popped = q.pop()
    q.requeue("a", popped[1])
    assert q.norm_counter("a") == 0.0
    return [popped, q.norm_counter("a"), q.pop(), q.depth()]


def case_bounded_gap_no_starvation(m):
    """Every client backlogged, per-dispatch charges bounded by U: the
    normalized counters stay within U/w_i + U/w_j; the dispatch order."""
    rng = random.Random(0)
    U = 64
    weights = {"a": 1.0, "b": 2.0, "c": 1.0, "whale": 1.0}
    clients = sorted(weights)
    q = m.adm.FairAdmissionQueue(weights=weights)
    for c in clients:
        q.push(c, 0)
    tokens_of = {c: U if c == "whale" else rng.randint(4, 12)
                 for c in clients}
    order = []
    for _ in range(600):
        client, _ = q.pop()
        q.charge(client, tokens_of[client])
        q.done(client)
        order.append(client)
        q.push(client, 0)
        for i, ci in enumerate(clients):
            for cj in clients[i + 1:]:
                gap = abs(q.norm_counter(ci) - q.norm_counter(cj))
                assert gap <= U / weights[ci] + U / weights[cj]
    served = {c: order.count(c) for c in clients}
    assert all(served.values()) and served["whale"] < served["a"] / 2
    assert served["b"] > served["a"]
    return [order, {c: q.norm_counter(c) for c in clients}]


def case_activation_lift(m):
    q = m.adm.FairAdmissionQueue()
    q.push("busy", 0)
    c, _ = q.pop()
    q.charge(c, 1000)
    q.push("busy", 0)
    q.done(c)
    q.push("sleeper", 0)
    lifted = q.norm_counter("sleeper")
    assert lifted >= 1000.0
    got = [q.pop()[0], q.pop()[0]]
    assert set(got) == {"busy", "sleeper"}
    return [lifted, got]


def case_random_interleavings(m):
    """Seeded push / pop / charge / requeue / begin / purge interleavings:
    every pop, counter and depth along the way."""
    rng = random.Random(7)
    trace = []
    for _ in range(40):
        q = m.adm.FairAdmissionQueue(weights={"y": 2.0})
        clients = ["x", "y", "z"]
        pushed = 0
        for _ in range(rng.randint(1, 120)):
            kind, val = rng.randint(0, 5), rng.randint(0, 32)
            c = clients[val % 3]
            if kind == 0:
                q.push(c, pushed)
                pushed += 1
            elif kind == 1:
                got = q.pop()
                trace.append(got)
                if got is not None:
                    backlogged = q.backlogged()
                    assert all(q.norm_counter(got[0])
                               <= q.norm_counter(b) + 1e-9
                               for b in backlogged)
                    q.charge(got[0], 1 + val)
                    if val % 4:
                        q.done(got[0])
                    else:
                        q.requeue(got[0], got[1])
            elif kind == 2:
                q.charge(c, val)
            elif kind == 3:
                q.begin(c)
            elif kind == 4:
                trace.append(q.purge(lambda _c, item: item % 5 == val % 5))
            else:
                q.done(c)
            trace.append((q.depth(), [q.norm_counter(x) for x in clients]))
    return trace


def _snap(ttft=0.0, waiting=0, running=0, swapped=0, swapping_in=0,
          parked=(), draining=False):
    return {"predicted_ttft_us": ttft, "waiting": waiting,
            "running": running, "swapped": swapped,
            "swapping_in": swapping_in, "parked": tuple(parked),
            "draining": draining}


def case_route_new_and_affinity(m):
    r = m.rt.Router(3)
    out = [r.route_new(1, [_snap(ttft=500.0), _snap(ttft=100.0),
                           _snap(ttft=300.0)]),
           r.route_followup(1),
           r.route_new(2, [_snap(running=2), _snap(running=1),
                           _snap(running=1)])]
    r.release(1)
    with pytest.raises(KeyError):
        r.route_followup(1)
    out.append(r.route_new(3, [_snap(draining=True), _snap(ttft=9e9),
                               _snap(ttft=9e9, running=1)]))
    with pytest.raises(RuntimeError):
        r.route_new(4, [_snap(draining=True)] * 3)
    assert out[:3] == [1, 1, 1]
    return [out, dict(r.affinity)]


def case_plan_migrations(m):
    r = m.rt.Router(2, migrate_threshold=4)
    for h in (10, 11, 12, 13):
        r.affinity[h] = 0
    snaps = [_snap(running=4, waiting=2, parked=(10, 11, 12, 13)), _snap()]
    out = [r.plan_migrations(snaps), r.plan_migrations(snaps, busy={10, 12}),
           r.plan_migrations([_snap(running=2), _snap()]),
           r.plan_migrations([_snap(running=9, parked=(10,)),
                              _snap(draining=True)])]
    r.note_migrated(10, 1)
    assert out[0] == [(10, 0, 1), (11, 0, 1), (12, 0, 1)]
    return [out, r.n_migrations, dict(r.affinity)]


def _ev(kind, h, **kw):
    return {"kind": kind, "handle": h, **kw}


AUDIT_LOGS = [
    [[_ev("arrive", 1), _ev("finish", 1, retained=True),
      _ev("migrate_out", 1), _ev("arrive", 2),
      _ev("finish", 2, retained=False)],
     [_ev("migrate_in", 1), _ev("swap_in", 1),
      _ev("finish", 1, retained=False)]],
    [[_ev("arrive", 1), _ev("finish", 1, retained=True)],
     [_ev("swap_in", 1)]],
    [[_ev("arrive", 5)], [_ev("arrive", 5)]],
    [[_ev("arrive", 5), _ev("finish", 5, retained=True),
      _ev("migrate_out", 5)], [_ev("migrate_in", 5)]],
    [[_ev("drain", -1)]],
    [[_ev("arrive", 3), _ev("abort", 3), _ev("release", 3),
      _ev("migrate_out", 4), _ev("arrive", 3), _ev("arrive", 3)]],
]


def case_affinity_audit(m):
    counts = [m.rt.count_affinity_violations(logs) for logs in AUDIT_LOGS]
    assert counts[:5] == [0, 1, 1, 0, 0]
    return counts


CASES = [case_slo_priority, case_capacity_refusal,
         case_requeue_front_uncharged, case_bounded_gap_no_starvation,
         case_activation_lift, case_random_interleavings,
         case_route_new_and_affinity, case_plan_migrations,
         case_affinity_audit]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_decisions_equal_the_reference(case):
    assert case(PACKAGES["port"]) == case(PACKAGES["reference"])


def test_load_event_log_reads_what_the_reference_reads(tmp_path):
    path = tmp_path / "r0.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in AUDIT_LOGS[0][0])
                    + "\n")
    assert router.load_event_log(str(path)) == \
        jax_router.load_event_log(str(path)) == AUDIT_LOGS[0][0]


# ---------------------------------------------------------------------------
# DirectCluster and the bench
# ---------------------------------------------------------------------------


def _close(got, want, path="$"):
    """Equal structure; ints, strings and None exactly, floats to 1e-12."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=0, abs_tol=1e-12), \
            (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_storm_workload_equals_the_reference():
    kw = dict(n_clients=4, duration_s=8.0, storms=1, seed=3)
    got, want = loadgen.storm_workload(**kw), jax_loadgen.storm_workload(**kw)
    assert [(t, c, conv.conv_id, conv.arrival_s, conv.think_time_s,
             [(u.prompt_tokens, u.response_tokens) for u in conv.turns],
             slo.ttft_ms, slo.tbt_ms) for t, c, conv, slo in got] == \
        [(t, c, conv.conv_id, conv.arrival_s, conv.think_time_s,
          [(u.prompt_tokens, u.response_tokens) for u in conv.turns],
          slo.ttft_ms, slo.tbt_ms) for t, c, conv, slo in want]


def test_direct_cluster_storm_equals_the_reference():
    def run(mod):
        wl = mod.storm_workload(n_clients=4, duration_s=8.0, storms=1,
                                seed=3)
        cluster = mod.DirectCluster(2, config=mod.sim_engine_config())
        cluster.run(wl)
        return cluster.results()

    got = run(loadgen)
    assert got == run(jax_loadgen)
    assert got["turns_finished"] > 0 and got["affinity_violations"] == 0
    assert set(got["per_client_attainment"]) == \
        {f"client{i}" for i in range(4)}


def test_bench_equals_the_reference_and_bench_frontend_json(monkeypatch):
    """The 60-s bench with the short-copy repair taken out of the port's
    swap-in (``_swap_in`` as ``_swap_in_copy``, which restores every copy
    whole, as the reference's ``_swap_in``).  The repaired bench:
    ``test_bench_with_short_copy_resumes``."""
    monkeypatch.setattr(ServingEngine, "_swap_in",
                        ServingEngine._swap_in_copy)
    got = loadgen.run_bench(seed=0, duration_s=60.0)
    _close(got, jax_loadgen.run_bench(seed=0, duration_s=60.0))
    with open(os.path.join(os.path.dirname(__file__), "..",
                           "BENCH_frontend.json")) as f:
        _close(got, json.load(f))
    one, two = got["rows"]
    assert (one["turns_finished"], two["turns_finished"]) == (536, 536)
    assert (one["migrations"], two["migrations"]) == (0, 98)
    assert one["affinity_violations"] == two["affinity_violations"] == 0
    assert round(one["jain_attainment"], 5) == 0.99139
    assert round(two["jain_attainment"], 5) == 0.99938


def test_bench_with_short_copy_resumes(monkeypatch):
    """The port's 60-s bench as it runs.  The one-replica row swaps
    requests back in over CPU copies shorter than their KV (swap-outs cut
    short for want of CPU blocks), which the port resumes by restoring
    the valid prefix and recomputing the rest
    (``_resume_short_copy``), so that row's latencies part from
    ``BENCH_frontend.json``'s, made by the reference, which restores
    such copies whole.  No replica restores a block past a copy's valid
    prefix; every row keeps the reference's turns, migrations and
    violations; the two-replica row, which meets no short copy, equals
    the reference's (counts exact, floats to 1e-12)."""
    seen = []
    run = loadgen.DirectCluster.run

    def watched(self, work):
        seen.append([chip_smoke.watch_swap_ins(e) for e in self.engines])
        return run(self, work)
    monkeypatch.setattr(loadgen.DirectCluster, "run", watched)
    got = loadgen.run_bench(seed=0, duration_s=60.0)
    with open(os.path.join(os.path.dirname(__file__), "..",
                           "BENCH_frontend.json")) as f:
        want = json.load(f)
    short = [sum(len(chip_smoke.short_swap_ins(w["swap_ins"])) for w in row)
             for row in seen]
    assert short[0] > 0 and short[1] == 0, short
    assert not [r for row in seen for w in row
                for r in chip_smoke.past_valid_prefix(w["restores"])]
    assert set(got) == set(want) and got["workload"] == want["workload"]
    for g, w in zip(got["rows"], want["rows"]):
        for key in ("replicas", "turns_finished", "migrations",
                    "affinity_violations"):
            assert g[key] == w[key], key
    _close(got["rows"][1], want["rows"][1])


# ---------------------------------------------------------------------------
# real mode on the reduced model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine_model():
    cfg = get_smoke_config("qwen2-1.5b")
    return {"cfg": cfg, "params": T.init_params(cfg, seed=0, device="cpu")}


def _real_cfg(gpu_blocks: int = 32, cpu_blocks: int = 128):
    return EngineConfig(mode="real", num_gpu_blocks=gpu_blocks,
                        num_cpu_blocks=cpu_blocks, max_running=4,
                        max_batch=4).with_policy("fastswitch")


async def _line(reader, timeout: float = 60.0) -> dict:
    """The server's next event (a hang fails the test instead)."""
    return json.loads(await asyncio.wait_for(reader.readline(), timeout))


def _drain(eng, max_iters=20_000):
    outs = []
    it = 0
    while eng.has_work() and it < max_iters:
        outs.extend(eng.step())
        it += 1
    assert not eng.has_work()
    return outs


def _turn_tokens(outs, turn):
    return [t for o in outs if o.token_ids and o.turn == turn
            for t in o.token_ids]


def session_kv(eng, handle):
    """The bytes of a parked session's CPU reuse copy (its valid prefix),
    once every in-flight copy writing them has landed."""
    meta = eng.reuse.export_copy(handle)
    nblk = -(-eng.reuse.valid_tokens(handle) // eng.config.block_size)
    ids = meta["block_ids"][:nblk]
    for f in eng.swap.data_deps(ids):
        f.result()
    return eng.pools.cpu[:, :, np.asarray(ids)].copy()


def test_migration_round_trip_byte_exact(engine_model,
                                         swaps_follow_the_clock):
    """A parked session exported from replica A and imported into replica
    B: the KV bytes B installs are those A shipped, which are A's reuse
    copy; B continues with exactly the tokens of a session that never
    moved, and its reuse copy after the second turn equals that
    session's byte for byte."""
    vocab = engine_model["cfg"].vocab_size
    p1 = synth_prompt_ids(21, 0, 20, vocab)
    p2 = synth_prompt_ids(21, 1, 12, vocab)
    samp = SamplingParams(max_tokens=8)

    ref = ServingEngine(_real_cfg(), model_bundle=engine_model,
                        stream_tokens=True)
    h = ref.add_request(p1, samp, retain_kv=True)
    outs = _drain(ref)
    ref.continue_session(h, p2, samp, retain_kv=True)
    outs += _drain(ref)
    ref_t0, ref_t1 = _turn_tokens(outs, 0), _turn_tokens(outs, 1)
    assert len(ref_t0) == 8 and len(ref_t1) == 8

    a = ServingEngine(_real_cfg(), model_bundle=engine_model,
                      stream_tokens=True)
    b = ServingEngine(_real_cfg(), model_bundle=engine_model,
                      stream_tokens=True)
    ha = a.add_request(p1, samp, retain_kv=True)
    assert _turn_tokens(_drain(a), 0) == ref_t0
    shipped_from = session_kv(a, ha)
    payload = a.export_session(ha)
    assert ha not in a.parked and payload["valid_tokens"] > 0
    assert np.array_equal(payload["kv"], shipped_from)
    hb = b.import_session(payload)
    assert b.reuse.valid_tokens(hb) == payload["valid_tokens"]
    assert np.array_equal(session_kv(b, hb), payload["kv"])
    b.continue_session(hb, p2, samp, retain_kv=True)
    assert _turn_tokens(_drain(b), 1) == ref_t1
    assert b.reuse.valid_tokens(hb) == ref.reuse.valid_tokens(h)
    assert np.array_equal(session_kv(b, hb), session_kv(ref, h))
    for eng in (ref, a, b):
        eng.shutdown()


async def _equivalence_client(host, port, convs, continue_idx, samp_tokens):
    """Submit every conversation, stream tokens, follow up on ONE
    retained session; returns {(conv_idx, turn): [token ids]}."""
    reader, writer = await asyncio.open_connection(host, port)
    for i, (pp1, _) in enumerate(convs):
        writer.write(json.dumps(
            {"op": "submit", "id": str(i), "client": "eq", "prompt": pp1,
             "max_tokens": samp_tokens}).encode() + b"\n")
    await writer.drain()
    conv_of, turn_of, streams = {}, {}, {}
    expected, n_finish, continued = len(convs), 0, False
    while n_finish < expected:
        line = await reader.readline()
        assert line, "server closed mid-stream"
        ev = json.loads(line)
        et = ev.get("event")
        if et == "accepted":
            rid = ev.get("id")
            if rid is not None and rid.isdigit():
                conv_of[ev["handle"]] = int(rid)
                turn_of.setdefault(ev["handle"], 0)
        elif et == "token":
            h = ev["handle"]
            streams.setdefault((conv_of[h], turn_of[h]), []).extend(
                ev.get("token_ids") or [])
        elif et == "finish":
            h = ev["handle"]
            n_finish += 1
            turn_of[h] += 1
            if ev.get("retained"):
                if conv_of[h] == continue_idx and not continued:
                    continued = True
                    expected += 1
                    writer.write(json.dumps(
                        {"op": "continue", "handle": h, "id": "fup",
                         "prompt": convs[conv_of[h]][1],
                         "max_tokens": samp_tokens}).encode() + b"\n")
                else:
                    writer.write(json.dumps(
                        {"op": "release", "handle": h}).encode() + b"\n")
                await writer.drain()
        elif et == "error":
            raise AssertionError(f"server error {ev}")
    writer.close()
    await writer.wait_closed()
    return streams


def test_loopback_driver_equivalence_bit_exact(engine_model, tmp_path,
                                               swaps_follow_the_clock):
    """The full network path — sockets, fair queue, router, threaded
    replicas — emits the same greedy token streams as direct
    single-engine runs of each conversation, and its event logs pass the
    audit; each replica launched its kernels' plain versions on its own
    pool."""
    from repro_torch.frontend.server import FrontendServer

    vocab = engine_model["cfg"].vocab_size
    convs = [(synth_prompt_ids(30 + i, 0, 16 + 4 * i, vocab),
              synth_prompt_ids(30 + i, 1, 12, vocab)) for i in range(3)]
    continue_idx, samp_tokens = 0, 6

    ref = {}
    for i, (pp1, pp2) in enumerate(convs):
        eng = ServingEngine(_real_cfg(), model_bundle=engine_model,
                            stream_tokens=True)
        h = eng.add_request(pp1, SamplingParams(max_tokens=samp_tokens),
                            retain_kv=True)
        ref[(i, 0)] = _turn_tokens(_drain(eng), 0)
        if i == continue_idx:
            eng.continue_session(h, pp2,
                                 SamplingParams(max_tokens=samp_tokens))
            ref[(i, 1)] = _turn_tokens(_drain(eng), 1)

    engines = [ServingEngine(_real_cfg(), model_bundle=engine_model,
                             stream_tokens=True) for _ in range(2)]

    async def go():
        srv = FrontendServer(engines)
        host, port = await srv.start()
        try:
            return await _equivalence_client(host, port, convs,
                                             continue_idx, samp_tokens)
        finally:
            await srv.close()

    streams = asyncio.run(go())
    assert streams == ref
    logs = [[ev.as_dict() for ev in e.events] for e in engines]
    assert router.count_affinity_violations(logs) == 0
    assert all(any(ev["kind"] == "arrive" for ev in log) for log in logs)


def test_real_smoke_clients_and_a_forced_migration(engine_model, tmp_path,
                                                   swaps_follow_the_clock):
    """``run_smoke`` over two real replicas with token-id prompts (the
    card's ``frontend`` phase at the reduced width), and, before the
    drain, ``FrontendServer.migrate`` moves a parked session whose
    follow-up then streams on its new home the tokens a direct engine
    makes."""
    vocab = engine_model["cfg"].vocab_size
    p1 = synth_prompt_ids(5, 0, 24, vocab)
    p2 = synth_prompt_ids(5, 1, 10, vocab)
    direct = ServingEngine(_real_cfg(), model_bundle=engine_model,
                           stream_tokens=True)
    h = direct.add_request(p1, SamplingParams(max_tokens=6), retain_kv=True)
    want0 = _turn_tokens(_drain(direct), 0)
    direct.continue_session(h, p2, SamplingParams(max_tokens=6))
    want1 = _turn_tokens(_drain(direct), 1)

    async def migrate_one(srv):
        reader, writer = await asyncio.open_connection(srv.host, srv.port)

        async def turn(msg):
            writer.write(json.dumps(msg).encode() + b"\n")
            await writer.drain()
            evs = []
            while not evs or evs[-1]["event"] != "finish":
                evs.append(await _line(reader))
            return evs

        def accepted(evs):
            return next(e for e in evs if e["event"] == "accepted")

        evs = await turn({"op": "submit", "client": "m", "prompt": p1,
                          "max_tokens": 6})
        handle, src = accepted(evs)["handle"], accepted(evs)["replica"]
        payload = await srv.migrate(handle, 1 - src)
        evs1 = await turn({"op": "continue", "handle": handle,
                           "prompt": p2, "max_tokens": 6})
        writer.write(json.dumps({"op": "release",
                                 "handle": handle}).encode() + b"\n")
        await writer.drain()
        writer.close()
        await writer.wait_closed()
        return {"src": src, "replica": accepted(evs1)["replica"],
                "valid": payload["valid_tokens"],
                "turns": [[t for e in es if e["event"] == "token"
                           for t in e["token_ids"]] for es in (evs, evs1)]}

    def make_engines(mk_sink):
        # the launcher's real defaults: room for the smoke's 512-token
        # request that is aborted mid-decode
        return [ServingEngine(_real_cfg(64, 256), model_bundle=engine_model,
                              event_sink=mk_sink(i), stream_tokens=True)
                for i in range(2)]

    res = loadgen.run_smoke(str(tmp_path / "rfe"), make_engines,
                            vocab=vocab, after=migrate_one)
    assert res["affinity_violations"] == 0 and res["turns_finished"] == 9
    moved = res["after"]
    assert moved["replica"] == 1 - moved["src"] and moved["valid"] > 0
    assert moved["turns"] == [want0, want1]
    for client in res["clients"]:
        for turns in client["turns"].values():
            assert all(len(t["tokens"]) == (8 if i == 0 else 6)
                       for i, t in enumerate(turns)
                       if t.get("reason") == "length")


# ---------------------------------------------------------------------------
# the server's repairs
# ---------------------------------------------------------------------------


def test_abort_finishes_a_turn_once_when_the_replica_stepped_first():
    """The engine's own abort output can reach the loop before the
    server's acknowledgement (the replica steps between the two): the
    client still sees one finish for the turn, and the fair queue one
    ``done``."""
    from repro_torch.frontend.server import FrontendServer

    eng = loadgen.smoke_engines(lambda i: None, 1)[0]
    real_step = eng.step

    def paced_step(*a, **k):
        time.sleep(0.002)          # the abort lands long before the end
        return real_step(*a, **k)
    eng.step = paced_step

    async def go():
        srv = FrontendServer([eng])
        real_abort = eng.abort

        def abort_then_step(handle):
            ok = real_abort(handle)
            srv.loop.call_soon_threadsafe(srv._on_outputs, 0, eng.step())
            return ok
        eng.abort = abort_then_step
        host, port = await srv.start()
        reader, writer = await asyncio.open_connection(host, port)
        writer.write(json.dumps({"op": "submit", "client": "c",
                                 "prompt": 16, "max_tokens": 3000})
                     .encode() + b"\n")
        await writer.drain()
        # a replica may stream tokens before the dispatcher's "accepted"
        evs = [await _line(reader)]
        while evs[-1]["event"] == "token":
            evs.append(await _line(reader))
        assert evs[-1]["event"] == "accepted", evs
        writer.write(json.dumps({"op": "abort", "handle": evs[-1]["handle"]})
                     .encode() + b"\n")
        await writer.drain()
        while evs[-1]["event"] != "finish":
            evs.append(await _line(reader))
        await asyncio.sleep(0.2)
        writer.write(b'{"op": "drain"}\n')
        await writer.drain()
        evs.append(await _line(reader))
        writer.close()
        await writer.wait_closed()
        inflight = dict(srv.queue._inflight)
        await srv.close()
        return evs, inflight

    evs, inflight = asyncio.run(go())
    finishes = [e for e in evs if e["event"] == "finish"]
    assert len(finishes) == 1 and finishes[0]["reason"] == "abort"
    assert evs[-1] == {"event": "drained"} and inflight == {}


def test_a_request_the_engine_refuses_gets_400_and_serving_goes_on(
        engine_model):
    """A token count sent to a real replica: the engine raises
    ``ValueError``; the client gets a 400 and the next submit is
    served."""
    from repro_torch.frontend.server import FrontendServer

    eng = ServingEngine(_real_cfg(), model_bundle=engine_model,
                        stream_tokens=True)

    async def go():
        srv = FrontendServer([eng])
        host, port = await srv.start()
        reader, writer = await asyncio.open_connection(host, port)
        out = []
        for prompt in (12, list(range(3, 15))):
            writer.write(json.dumps({"op": "submit", "id": "r",
                                     "prompt": prompt, "max_tokens": 3,
                                     "retain": False}).encode() + b"\n")
            await writer.drain()
            evs = [await _line(reader)]
            while evs[-1]["event"] not in ("finish", "error"):
                evs.append(await _line(reader))
            out.append(evs)
        writer.close()
        await writer.wait_closed()
        await srv.close()
        return out

    refused, served = asyncio.run(go())
    assert [(e["event"], e["code"]) for e in refused] == [("error", 400)]
    assert "token ids" in refused[0]["message"]
    assert served[0]["event"] == "accepted"
    assert served[-1]["event"] == "finish" and \
        served[-1]["reason"] == "length"


def test_close_does_not_wait_on_a_connected_client():
    from repro_torch.frontend.server import FrontendServer

    async def go():
        srv = FrontendServer(loadgen.smoke_engines(lambda i: None, 2))
        host, port = await srv.start()
        reader, writer = await asyncio.open_connection(host, port)
        await asyncio.wait_for(srv.close(), timeout=30)
        line = await asyncio.wait_for(reader.read(), timeout=30)
        writer.close()
        return line

    assert asyncio.run(go()) == b""


def test_loadgen_smoke_cli(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = tmp_path / "smoke.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.frontend.loadgen", "--smoke",
         "--events-prefix", str(tmp_path / "fe"), "--json-out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(out.read_text())
    assert res == json.loads(proc.stdout)
    assert res["bench"] == "frontend_smoke" and res["replicas"] == 2
    assert res["affinity_violations"] == 0 and res["turns_finished"] == 9
    assert res["events_validated"] == [str(tmp_path / f"fe_r{i}.jsonl")
                                       for i in range(2)]

