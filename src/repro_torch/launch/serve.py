"""Serving launcher of the port: trace replays and the online serving API.

Counterpart of ``repro/launch/serve.py``, with the reference's flags and
output lines and one more flag, ``--device {cuda,cpu}`` (default
``cuda``), for real mode:

  * ``--device cuda`` serves the arch's published config at full width
    (``get_config``) with seeded random weights made on the card
    (``init_params(cfg, seed, device)``) through the hand-written CUDA
    kernels.  With no GPU it fails; it never falls back to the CPU.
  * ``--device cpu`` serves the arch's reduced config
    (``get_smoke_config``, the reference's reduced model) with the
    kernels' plain PyTorch versions.

Sim mode touches no device.  TTFT and TBT come from the engine's
simulated clock, modelled by the A10 cost model (``io/cost_model.py``),
in real mode too; ``callstack_wall_s`` is real wall time.  Real mode's
``--out`` results add, per run, the hand-written kernels' launches
(``kernel_launches``; 0 on the CPU, where the plain versions run), and
the online run adds each conversation's token history
(``token_histories``).

  # sim-mode replay, both policies (the paper's comparison)
  PYTHONPATH=src python -m repro_torch.launch.serve --policy vllm \
      --policy fastswitch --conversations 200 --update-freq 0.04

  # real mode on the card, full width
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --real --policy vllm --policy fastswitch --conversations 8

  # the MoE model (64 experts, top-8) on the card, and its reduced
  # config on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --real --conversations 2 --policy fastswitch
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --real --device cpu --conversations 2 --policy fastswitch

  # online smoke on the CPU at the reduced width, with its event log
  PYTHONPATH=src python -m repro_torch.launch.serve --online --smoke \
      --real --device cpu --events /tmp/events.jsonl

  # chaos, admission control, drain: as the reference
  PYTHONPATH=src python -m repro_torch.launch.serve --online --chaos --smoke

  # the prefix cache's smoke (implies --real --online): a 49-token system
  # prompt shared by every conversation, the C1/C2 sanitizer every step;
  # --system-prompt alone opens the conversations the same way with the
  # cache off (the port's flag, for comparing the two runs' tokens)
  PYTHONPATH=src python -m repro_torch.launch.serve --prefix-cache \
      --online --smoke --device cpu

  # network front-end: 2 replicas behind the fair-admission router,
  # JSON lines on localhost:8471, one event log per replica at
  # /tmp/fe_r<i>.jsonl (``repro_torch.frontend``); real replicas on the
  # card share one parameter bundle and take token-id prompts
  PYTHONPATH=src python -m repro_torch.launch.serve --serve --router 2 \
      --real --events /tmp/fe
  #   {"op": "submit", "client": "me", "prompt": [1, 2, 3], "max_tokens": 16}
  #   {"op": "continue", "handle": 0, "prompt": [4, 5]}   (KV-reuse turn)
  #   {"op": "drain"}                                      (graceful stop)

Every mode of the reference's launcher is served.  The engine's
tensor-parallel mesh (``EngineConfig.mesh_shape``) is served by the engine
(``launch/mesh.py``); as in the reference, no launcher flag sets it.
"""
from __future__ import annotations

import argparse
import json
import random


def _build_real_bundle(arch: str, seed: int, device: str = "cuda"):
    """The model bundle real mode serves: on ``cuda`` the arch's full
    config with random weights from ``seed`` made on the card, on ``cpu``
    its reduced config; the matmul weights cast to bf16 as they are
    drawn (``init_params(serving=True)``).  Raises ``SystemExit`` where
    the arch is not served by the paged path or no GPU is there for
    ``cuda``."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.paged import supports_paged
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: torch.cuda.is_available() is "
                             "false; pass --device cpu to serve the "
                             "reduced model on the CPU")
        cfg = get_config(arch)
    else:
        cfg = get_smoke_config(arch)
    if not supports_paged(cfg):
        raise SystemExit(
            f"{arch}: real-mode serving needs a uniform GQA arch "
            "(paged pool path); use sim mode for this family")
    try:
        T.check_supported(cfg)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    # the serving copy (matmul weights in bf16, each cast as it is
    # drawn) and no fp32 tree: each runner's ``serving_params`` then keeps
    # these tensors, and olmoe-1b-7b's experts take 13.4 GB where the
    # fp32 tree took 27.7
    params = T.init_params(cfg, seed=seed, device=device, serving=True)
    return {"cfg": cfg, "params": params}


def _serving_kernels() -> dict:
    """The serving path's kernel wrappers, by name."""
    from repro_torch.kernels import block_copy as bc
    from repro_torch.kernels import paged_attention as pa
    return {"paged_attention": pa.paged_attention,
            "block_gather_runs": bc.block_gather_runs,
            "block_scatter_runs": bc.block_scatter_runs}


def _launch_counts() -> dict:
    return {n: fn.launches for n, fn in _serving_kernels().items()}


def _reset_launch_counts() -> None:
    from repro_torch.kernels import launches
    launches.reset(*_serving_kernels().values())


def validate_event_log(path: str) -> int:
    """Assert the JSONL event log is well-formed: every line parses,
    kinds are known, timestamps are monotone, and every handle's
    lifecycle is coherent (an arrive first; at most one hard terminal
    among abort/drop/error/shed).
    System events (``drain``) carry a negative handle and sit outside
    any request lifecycle.  ``retry`` events must name a direction.
    Returns the number of events."""
    from repro_torch.core.request_api import EVENT_KINDS
    n = 0
    last_t = -1.0
    seen_arrive = set()
    terminal = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            assert {"t_us", "handle", "kind"} <= set(ev), f"bad event {ev}"
            assert ev["kind"] in EVENT_KINDS, f"unknown kind {ev['kind']}"
            assert ev["t_us"] >= last_t, "event log not time-ordered"
            last_t = ev["t_us"]
            h = ev["handle"]
            if h < 0:
                # engine-level event (drain): no per-request lifecycle
                assert ev["kind"] == "drain", f"system event kind: {ev}"
                n += 1
                continue
            if ev["kind"] in ("arrive", "migrate_in"):
                # migrate_in opens a handle's lifecycle on THIS replica
                # (the session arrived elsewhere and moved here)
                seen_arrive.add(h)
            else:
                assert h in seen_arrive, f"event before arrive: {ev}"
            if ev["kind"] == "retry":
                assert ev.get("direction") in ("in", "out"), \
                    f"retry without direction: {ev}"
            if ev["kind"] == "error":
                assert ev.get("error"), f"error event without message: {ev}"
            if ev["kind"] in ("abort", "drop", "error", "shed"):
                terminal.setdefault(h, []).append(ev["kind"])
            n += 1
    for h, kinds in terminal.items():
        # a retained session may finish several turns; exactly one
        # hard terminal (abort/drop/error/shed) may end it
        assert len(kinds) <= 1, f"handle {h} terminated twice: {kinds}"
    assert n > 0, "empty event log"
    return n


def run_online(args) -> dict:
    """Open-world client loop over the ServingEngine API.

    Deliberately an INDEPENDENT client — it shares no replay scaffold
    with ``FastSwitchEngine``'s replay (tests pin the two equivalent);
    what a network front-end would do, it does here inline."""
    import dataclasses

    from repro_torch.core import (EngineConfig, EngineDrainingError,
                                  EngineOverloadError, FaultPlan,
                                  SamplingParams, ServingEngine, SLOSpec)
    from repro_torch.data.priority import PriorityTrace
    from repro_torch.data.sharegpt import (prompt_for_turn,
                                           sample_conversations)

    policy = (args.policy or ["fastswitch"])[0]
    n_conv = 6 if args.smoke else args.conversations
    if args.chaos and args.smoke and not args.real:
        # the chaos smoke needs CONTENTION: a roomy pool never swaps, so
        # no swap-fault site is ever reached.  Starve it instead.
        n_conv = 16
        args.gpu_blocks = args.gpu_blocks or 64
        args.cpu_blocks = args.cpu_blocks or 256
        args.max_running = args.max_running or 4
        args.rate = max(args.rate, 20.0)
    model = None
    if args.real:
        model = _build_real_bundle(args.arch, args.seed, args.device)
        _reset_launch_counts()
        cfg = EngineConfig(
            mode="real",
            num_gpu_blocks=args.gpu_blocks or 64,
            num_cpu_blocks=args.cpu_blocks or 256,
            max_running=args.max_running or 4, max_batch=4,
        ).with_policy(policy)
        convs = sample_conversations(n_conv, rate_req_s=args.rate,
                                     seed=args.seed, prompt_mu=2.5,
                                     resp_mu=2.5, max_tokens=48)
    else:
        cfg = EngineConfig(
            mode="sim",
            num_gpu_blocks=args.gpu_blocks or (256 if args.smoke else 2048),
            num_cpu_blocks=args.cpu_blocks or (1024 if args.smoke else 8192),
            max_running=args.max_running or (8 if args.smoke else 32),
        ).with_policy(policy)
        convs = sample_conversations(n_conv, rate_req_s=args.rate,
                                     seed=args.seed,
                                     max_context=cfg.num_gpu_blocks * 8)

    # robustness wiring (DESIGN.md §7): seeded chaos schedule, invariant
    # sanitizer cadence, copy watchdog, bounded admission
    overrides = {}
    if args.prefix_cache:
        overrides["prefix_cache"] = True
        if args.smoke:
            # the prefix-cache smoke doubles as a refcount-conservation
            # gate: C1/C2 checked after every step
            overrides["check_invariants_every"] = 1
    if args.chaos:
        overrides["fault_plan"] = FaultPlan.chaos(seed=args.seed,
                                                  intensity=args.chaos)
        overrides["swap_watchdog_us"] = 100_000.0
        overrides["check_invariants_every"] = 1 if args.smoke else 50
    if args.max_waiting:
        overrides["max_waiting"] = args.max_waiting
        overrides["overload_policy"] = args.overload_policy
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    slo = None
    if args.slo_ttft_ms or args.slo_tbt_ms:
        slo = SLOSpec(ttft_ms=args.slo_ttft_ms or None,
                      tbt_ms=args.slo_tbt_ms or None)
    ev_file = open(args.events, "w") if args.events else None
    sink = (lambda ev: ev_file.write(json.dumps(ev.as_dict()) + "\n")) \
        if ev_file else None
    engine = ServingEngine(cfg, trace=PriorityTrace(args.pattern,
                                                    args.update_freq,
                                                    seed=args.seed),
                           model_bundle=model, event_sink=sink,
                           stream_tokens=args.stream and args.real)

    # shared "system prompt": with the prefix cache on, every
    # conversation's FIRST turn opens with the same token run so the
    # radix tree gets real cross-request hits (3 full blocks cacheable
    # out of 49 tokens at block_size 16)
    sys_prefix = []
    if args.prefix_cache or args.system_prompt:
        vocab = model["cfg"].vocab_size if model else 1 << 20
        sys_prefix = [(7 * i + 3) % vocab for i in range(49)]

    def prompt_for(conv, tix):
        toks = prompt_for_turn(
            conv, tix, model["cfg"].vocab_size if model else None)
        if tix == 0 and sys_prefix:
            toks = sys_prefix + list(toks)
        return toks

    rng = random.Random(args.seed + 1)
    pending = sorted(convs, key=lambda c: c.arrival_s)
    sleeping = []                    # (wake_s, conv, next_turn_idx)
    by_handle = {c.conv_id: c for c in convs}
    live, n_aborted, n_refused = set(), 0, 0
    iters = 0
    max_iters = 20_000 if args.real else 300_000
    while (pending or sleeping or engine.has_work()) and iters < max_iters:
        now_s = engine.clock.now_us / 1e6
        if args.drain and now_s >= args.drain and not engine.draining:
            # stop admissions; in-flight work runs to completion.  The
            # client drops its own backlog too — every further submit
            # would just raise EngineDrainingError.
            engine.drain()
            n_refused += len(pending) + len(sleeping)
            pending, sleeping = [], []
            print(f"draining at t={now_s:.2f}s "
                  f"({len(engine.sched.requests)} in flight)")
        while pending and pending[0].arrival_s <= now_s:
            conv = pending.pop(0)
            t = conv.turns[0]
            try:
                engine.add_request(
                    prompt_for(conv, 0),
                    SamplingParams(max_tokens=t.response_tokens),
                    slo=slo, handle=conv.conv_id,
                    retain_kv=len(conv.turns) > 1)
                live.add(conv.conv_id)
            except (EngineOverloadError, EngineDrainingError):
                n_refused += 1       # a real front-end would 429/503 here
        for entry in list(sleeping):
            if entry[0] <= now_s:
                sleeping.remove(entry)
                _, conv, tix = entry
                t = conv.turns[tix]
                try:
                    engine.continue_session(
                        conv.conv_id, prompt_for(conv, tix),
                        SamplingParams(max_tokens=t.response_tokens),
                        slo=slo, retain_kv=tix + 1 < len(conv.turns))
                    live.add(conv.conv_id)
                except (EngineOverloadError, EngineDrainingError):
                    n_refused += 1
        events = [w[0] * 1e6 for w in sleeping]
        if pending:
            events.append(pending[0].arrival_s * 1e6)
        outs = engine.step(until_us=min(events) if events else None)
        for out in outs:
            if args.stream and (out.token_ids or out.finished):
                ids = "".join(f" {t}" for t in (out.token_ids or []))
                mark = f" [{out.finish_reason}]" if out.finished else ""
                print(f"  req {out.handle}.{out.turn}:{ids}{mark}")
            if out.finished:
                live.discard(out.handle)
                conv = by_handle[out.handle]
                if (out.finish_reason in ("length", "stop")
                        and out.turn + 1 < len(conv.turns)):
                    sleeping.append((out.t_us / 1e6 + conv.think_time_s,
                                     conv, out.turn + 1))
        # cancellation: a random client hangs up mid-flight (any state)
        if args.cancel_frac and live and rng.random() < args.cancel_frac:
            victim = rng.choice(sorted(live))
            if engine.abort(victim):
                live.discard(victim)
                n_aborted += 1
                # the whole conversation is gone: drop queued follow-ups
                sleeping = [w for w in sleeping if w[1].conv_id != victim]
        iters += 1
    engine.shutdown()

    m = engine.metrics
    result = {**m.summary(), "slo": m.slo_summary(), **engine.swap.stats()}
    if args.real:
        result["kernel_launches"] = _launch_counts()
        # each conversation's tokens (prompts and generated) at its last
        # finished turn, for checks against a dense forward
        result["token_histories"] = {
            str(h): toks for h, toks in engine._token_hist_by_conv.items()}
    if args.chaos:
        result["faults_fired"] = dict(engine.faults.fired)
    print(f"online[{policy}] " + json.dumps(m.summary()))
    print("slo " + json.dumps(m.slo_summary()))
    if args.chaos:
        print("chaos " + json.dumps({
            "fired": dict(engine.faults.fired), "faulted": m.faulted,
            "swap_failure_resumes": m.swap_failure_resumes,
            "copy_retries": engine.swap.n_retries,
            "copy_failures": engine.swap.n_copy_failures,
            "watchdog_rescues": engine.swap.n_watchdog,
            "invariant_checks": m.invariant_checks}))
    if args.max_waiting or args.drain:
        print("admission " + json.dumps({
            "rejected": m.rejected, "shed": m.shed,
            "client_refused": n_refused}))
    if args.prefix_cache:
        result["prefix"] = engine.prefix.stats()
        print("prefix " + json.dumps(engine.prefix.stats()))
    if ev_file:
        ev_file.close()
        n_ev = validate_event_log(args.events)
        print(f"event log {args.events}: {n_ev} events, well-formed")
    if args.smoke:
        assert not engine.has_work(), "smoke run did not drain"
        assert m.total_tokens > 0, "smoke run served no tokens"
        assert len(m.request_stats) > 0, "no per-request SLO records"
        if args.cancel_frac:
            assert m.aborted == n_aborted, \
                f"abort accounting mismatch: {m.aborted} != {n_aborted}"
        if args.chaos:
            # the chaos smoke is a CONTAINMENT gate: with the sanitizer
            # on every step, faults must have fired and every live
            # request must still have ended in a terminal state
            assert sum(engine.faults.fired.values()) > 0, \
                "chaos smoke fired no faults"
            assert m.invariant_checks > 0, "invariant sanitizer never ran"
        if args.prefix_cache:
            # cross-request sharing must actually happen: every conv
            # after the first opens with the cached system prompt
            assert m.prefix_hits > 0, "prefix-cache smoke saw no hits"
            assert m.prefix_tokens_saved > 0, "prefix hits saved nothing"
            assert m.invariant_checks > 0, \
                "prefix smoke ran without the sanitizer"
        print(f"online smoke OK: {m.total_tokens} tokens, "
              f"{len(m.request_stats)} turns, {m.aborted} aborted, "
              f"{m.faulted} faulted")
    return result


def run_replay(args) -> dict:
    """Closed-world trace replay (FastSwitchEngine driving the serving
    core) — the benchmark path."""
    from repro_torch.core import EngineConfig, FastSwitchEngine
    from repro_torch.data.priority import PriorityTrace
    from repro_torch.data.sharegpt import sample_conversations, trace_stats

    policies = args.policy or ["fastswitch"]
    results = {}
    if args.real:
        model = _build_real_bundle(args.arch, args.seed, args.device)
        convs = sample_conversations(args.conversations, rate_req_s=args.rate,
                                     seed=args.seed, prompt_mu=3.0,
                                     resp_mu=3.0, max_tokens=96)
        for pol in policies:
            ec = EngineConfig(
                mode="real",
                num_gpu_blocks=args.gpu_blocks or 256,
                num_cpu_blocks=args.cpu_blocks or 1024,
                max_running=args.max_running or 8, max_batch=8,
            ).with_policy(pol)
            eng = FastSwitchEngine(
                ec, [c for c in convs],
                trace=PriorityTrace(args.pattern, args.update_freq,
                                    seed=args.seed),
                model_bundle=model)
            _reset_launch_counts()
            m = eng.run()
            results[pol] = {**m.summary(), **eng.swap.stats(),
                            "kernel_launches": _launch_counts()}
            print(pol, json.dumps(m.summary(), indent=None))
    else:
        convs = sample_conversations(args.conversations, rate_req_s=args.rate,
                                     seed=args.seed)
        print("trace:", trace_stats(convs))
        for pol in policies:
            ec = EngineConfig(
                mode="sim",
                num_gpu_blocks=args.gpu_blocks or 2048,
                num_cpu_blocks=args.cpu_blocks or 8192,
                max_running=args.max_running or 32,
            ).with_policy(pol)
            eng = FastSwitchEngine(
                ec, [c for c in convs],
                trace=PriorityTrace(args.pattern, args.update_freq,
                                    seed=args.seed))
            m = eng.run()
            results[pol] = {**m.summary(), **eng.swap.stats()}
            s = m.summary()
            print(f"{pol:12s} p99_ttft={s['p99_ttft_ms']:.1f}ms "
                  f"p999_tbt={s['p999_tbt_ms']:.1f}ms "
                  f"throughput={s['throughput_tok_s']:.1f} tok/s")
    return results


def run_serve(args) -> dict:
    """Network front-end mode: boot ``--router N`` engine replicas
    behind the fair-admission router and serve the JSON-lines protocol
    until interrupted (``repro_torch.frontend.server``).  ``--events
    PREFIX`` writes one JSONL event log per replica at
    ``PREFIX_r<i>.jsonl``.  Real replicas share one model bundle (on
    ``--device``) and own a pool each."""
    import asyncio

    from repro_torch.core import EngineConfig, ServingEngine
    from repro_torch.frontend.server import FrontendServer

    n = max(1, args.router)
    policy = (args.policy or ["fastswitch"])[0]
    model = (_build_real_bundle(args.arch, args.seed, args.device)
             if args.real else None)
    cfg = EngineConfig(
        mode="real" if args.real else "sim",
        num_gpu_blocks=args.gpu_blocks or (64 if args.real else 256),
        num_cpu_blocks=args.cpu_blocks or (256 if args.real else 1024),
        max_running=args.max_running or (4 if args.real else 8),
        max_batch=4 if args.real else 32,
        max_waiting=args.max_waiting,
        overload_policy=args.overload_policy,
    ).with_policy(policy)

    files = []
    engines = []
    for i in range(n):
        sink = None
        if args.events:
            # line-buffered: a long-running server is usually stopped by
            # SIGTERM, which never unwinds to the close() below — each
            # event must be durable the moment it is written
            f = open(f"{args.events}_r{i}.jsonl", "w", buffering=1)
            files.append(f)
            sink = (lambda fh: lambda ev: fh.write(
                json.dumps(ev.as_dict()) + "\n"))(f)
        engines.append(ServingEngine(cfg, model_bundle=model,
                                     event_sink=sink,
                                     stream_tokens=bool(args.stream
                                                        and args.real)))

    async def _run():
        srv = FrontendServer(engines, host=args.host, port=args.port)
        host, port = await srv.start()
        print(f"frontend: {n} {cfg.mode} replica(s) on {host}:{port}",
              flush=True)
        try:
            while True:
                await asyncio.sleep(3600.0)
        finally:
            await srv.close()

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        print("frontend: interrupted, shutting down", flush=True)
    finally:
        for f in files:
            f.close()
    return {"replicas": n, "mode": cfg.mode}


def main() -> None:
    from repro_torch.core.policies import POLICIES
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--real", action="store_true",
                    help="real model + paged pool (full width on cuda, "
                         "the reduced model on cpu)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="real mode's device: cuda serves the published "
                         "config at full width, cpu the reduced one")
    ap.add_argument("--policy", action="append", default=None,
                    choices=sorted(POLICIES))
    ap.add_argument("--conversations", type=int, default=100)
    ap.add_argument("--rate", type=float, default=1.0)
    ap.add_argument("--pattern", default="markov",
                    choices=["markov", "random"])
    ap.add_argument("--update-freq", type=float, default=0.02)
    ap.add_argument("--gpu-blocks", type=int, default=None)
    ap.add_argument("--cpu-blocks", type=int, default=None)
    ap.add_argument("--max-running", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    # online serving API (DESIGN.md §6)
    ap.add_argument("--online", action="store_true",
                    help="drive the open-world add_request/step API")
    ap.add_argument("--stream", action="store_true",
                    help="print per-request token deltas (real mode)")
    ap.add_argument("--events", default=None,
                    help="write the per-request JSONL event log here")
    ap.add_argument("--cancel-frac", type=float, default=0.0,
                    help="probability per step of aborting a live request")
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0)
    ap.add_argument("--slo-tbt-ms", type=float, default=0.0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny online run + event-log assertions (tier-1)")
    # robustness / failure containment (DESIGN.md §7)
    ap.add_argument("--chaos", nargs="?", const=1.0, type=float,
                    default=0.0, metavar="INTENSITY",
                    help="seeded fault-injection schedule "
                         "(FaultPlan.chaos; optional intensity, default 1)")
    ap.add_argument("--max-waiting", type=int, default=0,
                    help="bound the waiting queue (0 = unbounded)")
    ap.add_argument("--overload-policy", default="reject",
                    choices=["reject", "shed"],
                    help="full queue: reject the new request or shed "
                         "the least valuable waiting one")
    ap.add_argument("--drain", type=float, default=0.0, metavar="T_S",
                    help="enter drain mode at t=T_S: refuse new work, "
                         "finish in-flight requests, exit")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cross-request prefix cache (DESIGN.md §10); "
                         "implies --real --online")
    ap.add_argument("--system-prompt", action="store_true",
                    help="open every conversation's first turn with the "
                         "49-token system prompt that --prefix-cache "
                         "shares, with or without the cache (its "
                         "cache-off twin for a token comparison)")
    ap.add_argument("--serve", action="store_true",
                    help="network front-end: fair router over N replicas "
                         "(JSON lines over TCP, DESIGN.md §11)")
    ap.add_argument("--router", type=int, default=1, metavar="N",
                    help="number of engine replicas behind --serve")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8471,
                    help="--serve listen port (0 picks a free one)")
    args = ap.parse_args()

    if args.prefix_cache:
        args.real = True               # the cache lives on the real pool
        args.online = True
    if args.smoke and not args.online:
        args.online = True
    if args.smoke:
        args.cancel_frac = args.cancel_frac or 0.05
        if not (args.slo_ttft_ms or args.slo_tbt_ms):
            args.slo_ttft_ms, args.slo_tbt_ms = 2000.0, 200.0

    if args.serve:
        results = run_serve(args)
    elif args.online:
        results = run_online(args)
    else:
        results = run_replay(args)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
