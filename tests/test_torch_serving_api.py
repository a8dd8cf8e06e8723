"""The port's open-world serving API (``repro_torch.core.serving``):
lifecycle of ``add_request/step/abort/continue_session``, driver
equivalence between the trace-replay client and a hand-rolled online
client, per-request SLO attainment and the event stream — the cases of
``tests/test_serving_api.py``, and the driver-equivalence scenarios run
through both packages."""
import json

import pytest
import torch

from repro.core import EngineConfig as JaxEngineConfig
from repro.core import ServingEngine as JaxServingEngine
from repro.data import priority as jax_priority
from repro.data import sharegpt as jax_sharegpt
from repro_torch.core import (EngineConfig, FastSwitchEngine, SamplingParams,
                              ServingEngine, SLOSpec)
from repro_torch.data.priority import PriorityTrace
from repro_torch.data.sharegpt import (Conversation, Turn,
                                       sample_conversations,
                                       synth_prompt_ids)
from test_torch_serve import swaps_follow_the_clock  # noqa: F401
from torch_parity import (assert_histories_agree, assert_sim_equal,
                          pin_reference_sim_prefill, smoke_bundles)
from torch_threads import one_torch_thread  # noqa: F401


def _sim_engine(**kw):
    trace = kw.pop("trace", None) or PriorityTrace("random", 1e-9, seed=0)
    defaults = dict(mode="sim", num_gpu_blocks=128, num_cpu_blocks=512,
                    max_running=8)
    defaults.update(kw)
    return ServingEngine(EngineConfig(**defaults).with_policy("fastswitch"),
                         trace=trace)


def _drain(engine, max_iters=50_000):
    outs = []
    it = 0
    while engine.has_work() and it < max_iters:
        outs.extend(engine.step())
        it += 1
    assert not engine.has_work(), "engine did not drain"
    return outs


# ---------------------------------------------------------------------------
# basic lifecycle
# ---------------------------------------------------------------------------


def test_online_sim_lifecycle_and_output_contract():
    eng = _sim_engine()
    h1 = eng.add_request(10, SamplingParams(max_tokens=5))
    h2 = eng.add_request(8, SamplingParams(max_tokens=3))
    assert h1 != h2
    outs = _drain(eng)
    per = {h1: 0, h2: 0}
    for o in outs:
        per[o.handle] += o.new_tokens
    # per-request max_tokens honored exactly
    assert per == {h1: 5, h2: 3}
    # exactly one first-token marker per request, carrying its TTFT
    firsts = [o for o in outs if o.first_token]
    assert sorted(o.handle for o in firsts) == sorted([h1, h2])
    assert all(o.ttft_us is not None and o.ttft_us >= 0 for o in firsts)
    fins = [o for o in outs if o.finished]
    assert sorted(o.handle for o in fins) == sorted([h1, h2])
    assert all(o.finish_reason == "length" for o in fins)
    # event stream: arrive .. first_token .. finish, per handle, in order
    for h in (h1, h2):
        kinds = [e.kind for e in eng.events if e.handle == h]
        assert kinds[0] == "arrive" and kinds[-1] == "finish"
        assert kinds.index("first_token") < len(kinds) - 1
    eng.shutdown()


def test_add_request_validation():
    eng = _sim_engine()
    with pytest.raises(ValueError):
        eng.add_request(0)                      # empty prompt
    with pytest.raises(ValueError):
        eng.add_request(4, SamplingParams(max_tokens=0))
    h = eng.add_request(4)
    with pytest.raises(ValueError):
        eng.add_request(4, handle=h)            # handle collision
    # continue_session: live handle rejected, unknown handle rejected
    with pytest.raises(ValueError):
        eng.continue_session(h, 4)
    with pytest.raises(KeyError):
        eng.continue_session(12345, 4)
    assert eng.release_session(12345) is False
    eng.shutdown()


def test_retained_session_parks_and_releases():
    eng = _sim_engine()
    h = eng.add_request(6, SamplingParams(max_tokens=4), retain_kv=True)
    _drain(eng)
    assert h in eng.parked
    assert eng.reuse.valid_tokens(h) > 0        # CPU copy retained
    # follow-up turn reuses the prefix instead of re-prefilling it
    eng.continue_session(h, 5, SamplingParams(max_tokens=3))
    outs = _drain(eng)
    assert sum(o.new_tokens for o in outs if o.handle == h) == 3
    assert h not in eng.parked
    # second turn did NOT retain: copy released at finish
    assert eng.reuse.valid_tokens(h) == 0
    eng.shutdown()


def test_release_session_frees_cpu_copy():
    eng = _sim_engine()
    h = eng.add_request(6, SamplingParams(max_tokens=4), retain_kv=True)
    _drain(eng)
    free0 = eng.reuse.mgr.free_blocks()
    assert eng.release_session(h) is True
    assert h not in eng.parked
    assert eng.reuse.mgr.free_blocks() > free0
    assert eng.reuse.mgr.free_blocks() == eng.reuse.mgr.num_blocks
    eng.shutdown()


def test_real_mode_rejects_count_prompts_validates_sampling():
    bundle = smoke_bundles()[1]
    cfg_m, params = bundle["cfg"], bundle["params"]
    cfg = EngineConfig(mode="real", num_gpu_blocks=32, num_cpu_blocks=64,
                       max_running=2, max_batch=2).with_policy("fastswitch")
    eng = ServingEngine(cfg, trace=PriorityTrace("random", 1e-9, seed=0),
                        model_bundle={"cfg": cfg_m, "params": params})
    with pytest.raises(ValueError):
        eng.add_request(10)                     # counts are sim-only
    # out-of-range sampling params are rejected at add_request; IN-range
    # overrides are accepted (per-row (B, 3) sampling)
    with pytest.raises(ValueError):
        eng.add_request([1, 2, 3], SamplingParams(max_tokens=2,
                                                  temperature=-0.5))
    with pytest.raises(ValueError):
        eng.add_request([1, 2, 3], SamplingParams(max_tokens=2, top_p=0.0))
    # real-mode max_tokens=1 boundary: the prefill's first token is the
    # whole response — exactly one id appended past the prompt; a second
    # request overrides sampling per-request in the same batch
    prompt = synth_prompt_ids(0, 0, 9, cfg_m.vocab_size)
    h = eng.add_request(prompt, SamplingParams(max_tokens=1))
    prompt2 = synth_prompt_ids(1, 0, 9, cfg_m.vocab_size)
    h2 = eng.add_request(prompt2, SamplingParams(max_tokens=2,
                                                 temperature=0.7, top_k=8))
    outs = _drain(eng)
    assert sum(o.new_tokens for o in outs if o.handle == h) == 1
    assert len(eng._token_hist_by_conv[h]) == len(prompt) + 1
    assert sum(o.new_tokens for o in outs if o.handle == h2) == 2
    eng.shutdown()


# ---------------------------------------------------------------------------
# SLO attainment metrics
# ---------------------------------------------------------------------------


def test_slo_attainment_loose_and_tight():
    loose = _sim_engine()
    h = loose.add_request(10, SamplingParams(max_tokens=8),
                          slo=SLOSpec(ttft_ms=1e6, tbt_ms=1e6))
    _drain(loose)
    s = loose.metrics.slo_summary()
    assert s["ttft_slo_attainment"] == 1.0
    assert s["tbt_slo_attainment"] == 1.0
    assert s["slo_attainment"] == 1.0
    assert s["jain_fairness_tbt"] == 1.0
    loose.shutdown()

    tight = _sim_engine()
    tight.add_request(10, SamplingParams(max_tokens=8),
                      slo=SLOSpec(ttft_ms=1e-6, tbt_ms=1e-6))
    _drain(tight)
    s = tight.metrics.slo_summary()
    assert s["ttft_slo_attainment"] == 0.0
    assert s["tbt_slo_attainment"] == 0.0
    assert s["slo_attainment"] == 0.0
    tight.shutdown()
    # no-SLO runs report None, not garbage
    plain = _sim_engine()
    plain.add_request(10, SamplingParams(max_tokens=4))
    _drain(plain)
    s = plain.metrics.slo_summary()
    assert s["ttft_slo_attainment"] is None
    assert s["turns"] == 1
    plain.shutdown()


def test_max_tokens_one_generates_exactly_one():
    """Boundary of the SamplingParams contract: max_tokens=1 means the
    admission-time first token IS the whole response (regression: the
    decode loop over-generated by one)."""
    eng = _sim_engine()
    h = eng.add_request(8, SamplingParams(max_tokens=1))
    outs = _drain(eng)
    mine = [o for o in outs if o.handle == h]
    assert sum(o.new_tokens for o in mine) == 1
    fin = [o for o in mine if o.finished][0]
    assert fin.finish_reason == "length" and fin.generated == 1
    assert fin.first_token and fin.ttft_us is not None
    assert eng.metrics.total_tokens == 1
    eng.shutdown()


def test_recompute_chunked_mid_prefill_preempt_still_emits_first_token(
        monkeypatch):
    """A sim-mode recompute preemption landing MID chunked prefill (no
    first token yet) resumes through the chunked machine — and the
    completion must still emit exactly one first token (regression: the
    resume path skipped emission unconditionally).  The reference's sim
    route, pinned (``pin_reference_sim_prefill``): the port aborts such a
    request to a fresh admission, held by the next case."""
    from dataclasses import replace

    from repro_torch.core.policies import POLICIES
    pin_reference_sim_prefill(monkeypatch)
    pol = replace(POLICIES["vllm-recompute"], chunked_prefill_tokens=16)
    eng = ServingEngine(
        EngineConfig(mode="sim", num_gpu_blocks=64, num_cpu_blocks=256,
                     block_size=16, max_running=8, policy=pol),
        trace=PriorityTrace("random", 1e-9, seed=0))
    h = eng.add_request(60, SamplingParams(max_tokens=7))
    eng.step()
    req = eng._req(h)
    assert req.prefill_remaining > 0 and req.first_token_us is None, \
        "scenario never caught the request mid-prefill"
    eng._preempt(h)
    assert req.resume_tokens > 0
    outs = _drain(eng)
    firsts = [o for o in outs if o.handle == h and o.first_token]
    assert len(firsts) == 1, "resume completion lost/duplicated first token"
    assert len(eng.metrics.ttfts_us) == 1
    assert sum(o.new_tokens for o in outs if o.handle == h) == 7
    eng.shutdown()


@pytest.mark.parametrize("policy", ["vllm-recompute", "fastswitch"])
def test_sim_mid_prefill_preempt_restarts_the_prefill(policy):
    """The port's sim route: a request preempted MID chunked prefill, in
    either preemption mode, aborts the prefill as real mode does — back
    to WAITING with no prefill pending and no resume (the sanitizer's P1
    after every step), its processed prefix, and only it, counted in
    ``context_tokens`` (and, in swap mode, kept as a reuse copy) — and the
    re-admission emits exactly one first token and the turn's tokens."""
    from dataclasses import replace

    from repro_torch.core import ReqState
    from repro_torch.core.policies import POLICIES
    pol = replace(POLICIES[policy], chunked_prefill_tokens=16)
    eng = ServingEngine(
        EngineConfig(mode="sim", num_gpu_blocks=64, num_cpu_blocks=256,
                     block_size=16, max_running=8, policy=pol,
                     check_invariants_every=1),
        trace=PriorityTrace("random", 1e-9, seed=0))
    h = eng.add_request(60, SamplingParams(max_tokens=7))
    eng.step()
    req = eng._req(h)
    assert req.prefill_remaining == 44 and req.first_token_us is None, \
        "scenario never caught the request mid-prefill"
    assert req.context_tokens == 16          # the processed chunk
    eng._preempt(h)
    assert req.state is ReqState.WAITING
    assert (req.prefill_remaining, req.resume_tokens) == (0, 0)
    copy = eng.reuse.copies.get(h)
    if pol.preemption_mode == "swap":
        assert copy is not None and copy.valid_tokens == 16
    outs = _drain(eng)
    firsts = [o for o in outs if o.handle == h and o.first_token]
    assert len(firsts) == 1, "re-admission lost/duplicated first token"
    assert len(eng.metrics.ttfts_us) == 1
    assert sum(o.new_tokens for o in outs if o.handle == h) == 7
    kinds = [e.kind for e in eng.events if e.handle == h]
    assert kinds.count("admit") == 2 and "resume" not in kinds
    eng.shutdown()


def test_handle_reuse_after_abort_gets_fresh_outputs():
    """abort(h) between steps leaves a pending terminal output; an
    immediate add_request(handle=h) must NOT inherit it (regression: the
    new request appeared aborted at birth)."""
    eng = _sim_engine()
    h = eng.add_request(8, SamplingParams(max_tokens=40))
    eng.step()
    assert eng.abort(h) is True
    h2 = eng.add_request(6, SamplingParams(max_tokens=3), handle=h)
    assert h2 == h
    outs = _drain(eng)
    mine = [o for o in outs if o.handle == h]
    assert all(o.finish_reason != "abort" for o in mine), \
        "reused handle inherited the aborted lifecycle's output"
    assert sum(o.new_tokens for o in mine) == 3
    assert [o for o in mine if o.finished][0].finish_reason == "length"
    eng.shutdown()


def test_event_log_jsonl_well_formed(tmp_path):
    from repro_torch.launch.serve import validate_event_log
    path = tmp_path / "events.jsonl"
    lines = []
    eng = ServingEngine(
        EngineConfig(mode="sim", num_gpu_blocks=128, num_cpu_blocks=512,
                     max_running=4).with_policy("fastswitch"),
        trace=PriorityTrace("random", 1e-9, seed=0),
        event_sink=lambda ev: lines.append(json.dumps(ev.as_dict())))
    h1 = eng.add_request(6, SamplingParams(max_tokens=30), retain_kv=True)
    h2 = eng.add_request(6, SamplingParams(max_tokens=30))
    eng.step()
    assert eng.abort(h2) is True                 # cancelled mid-flight
    _drain(eng)
    eng.continue_session(h1, 4, SamplingParams(max_tokens=2))
    _drain(eng)
    path.write_text("\n".join(lines) + "\n")
    n = validate_event_log(str(path))
    assert n == len(lines)
    kinds = {json.loads(ln)["kind"] for ln in lines}
    assert {"arrive", "admit", "first_token", "finish", "continue",
            "abort"} <= kinds
    eng.shutdown()


# ---------------------------------------------------------------------------
# driver equivalence: the trace-replay client is a pure CLIENT of the
# API — a hand-rolled online loop must reproduce it exactly
# ---------------------------------------------------------------------------


def _online_replay(cfg, convs, trace, model=None, abort_at=None,
                   api=None):
    """Hand-rolled open-world client: same protocol as
    FastSwitchEngine.run() but written against the public API only.
    ``abort_at``: optional (iteration, handle) to cancel mid-flight.
    ``api``: (ServingEngine, SamplingParams, synth_prompt_ids) of the
    package to drive, by default the port's."""
    ServingEngine, SamplingParams, synth_prompt_ids = api or _PORT_API
    eng = ServingEngine(cfg, trace=trace, model_bundle=model)

    def prompt_for(conv, tix):
        t = conv.turns[tix]
        if model is None:
            return t.prompt_tokens
        return synth_prompt_ids(conv.conv_id, tix, t.prompt_tokens,
                                model["cfg"].vocab_size)

    pending = sorted(convs, key=lambda c: c.arrival_s)
    by_handle = {c.conv_id: c for c in convs}
    sleeping = []
    it = 0
    while (pending or sleeping or eng.has_work()) and it < 50_000:
        now_s = eng.clock.now_us / 1e6
        while pending and pending[0].arrival_s <= now_s:
            conv = pending.pop(0)
            t = conv.turns[0]
            eng.add_request(prompt_for(conv, 0),
                            SamplingParams(max_tokens=t.response_tokens),
                            handle=conv.conv_id,
                            retain_kv=len(conv.turns) > 1)
        for entry in list(sleeping):
            if entry[0] <= now_s:
                sleeping.remove(entry)
                _, conv, tix = entry
                t = conv.turns[tix]
                eng.continue_session(conv.conv_id, prompt_for(conv, tix),
                                     SamplingParams(
                                         max_tokens=t.response_tokens),
                                     retain_kv=tix + 1 < len(conv.turns))
        events = [w[0] * 1e6 for w in sleeping]
        if pending:
            events.append(pending[0].arrival_s * 1e6)
        outs = eng.step(until_us=min(events) if events else None)
        for out in outs:
            if out.finished and out.finish_reason == "length":
                conv = by_handle[out.handle]
                if out.turn + 1 < len(conv.turns):
                    sleeping.append((out.t_us / 1e6 + conv.think_time_s,
                                     conv, out.turn + 1))
        if abort_at is not None and it == abort_at[0]:
            eng.abort(abort_at[1])
            sleeping = [w for w in sleeping
                        if w[1].conv_id != abort_at[1]]
        it += 1
    if eng.runner is not None:
        eng.runner.flush()
    eng.swap.shutdown()
    return eng


_PORT_API = (ServingEngine, SamplingParams, synth_prompt_ids)


def _reference_api():
    from repro.core import SamplingParams as JaxSamplingParams
    return (JaxServingEngine, JaxSamplingParams,
            jax_sharegpt.synth_prompt_ids)


def test_driver_equivalence_sim():
    """FastSwitchEngine's replay and an independent online client must
    produce IDENTICAL schedules — same clock, same per-token latencies,
    same swap traffic (the sim half of the parity criterion)."""
    convs = sample_conversations(15, rate_req_s=2.0, seed=3)
    cfg = EngineConfig(mode="sim", num_gpu_blocks=256, num_cpu_blocks=1024,
                       max_running=8).with_policy("fastswitch")
    a = FastSwitchEngine(cfg, [c for c in convs],
                         trace=PriorityTrace("markov", 0.04, seed=7))
    ma = a.run(max_iterations=300_000)
    assert a.done()
    b = _online_replay(cfg, [c for c in convs],
                       PriorityTrace("markov", 0.04, seed=7))
    mb = b.metrics
    assert ma.total_tokens == mb.total_tokens
    assert ma.total_time_us == mb.total_time_us
    assert ma.ttfts_us == mb.ttfts_us
    assert ma.tbts_us == mb.tbts_us
    assert ma.preemptions == mb.preemptions
    assert a.swap.stats() == b.swap.stats()


@pytest.fixture(scope="module")
def engine_model():
    """The reduced qwen2-1.5b with the reference fixture's weights."""
    return smoke_bundles()[1]


def _storm(cid_skip=None):
    return [Conversation(conv_id=i, arrival_s=0.0,
                         turns=[Turn(16, 10), Turn(8, 6)], think_time_s=0.2)
            for i in range(4) if i != cid_skip]


def _storm_cfg():
    return EngineConfig(mode="real", num_gpu_blocks=8, num_cpu_blocks=256,
                        max_running=4, max_batch=4, block_size=16,
                        swap_chunk_blocks=1).with_policy("fastswitch")


def test_driver_equivalence_real_storm(engine_model):
    """Real-mode half of the parity criterion: under storm preemption +
    chunked swaps, the online client's greedy token streams must be
    bit-identical to the replay client's."""
    a = FastSwitchEngine(_storm_cfg(), _storm(),
                         trace=PriorityTrace("random", 0.5, seed=13),
                         model_bundle=engine_model)
    a.run(max_iterations=20_000)
    assert a.done()
    assert a.metrics.preemptions > 0
    b = _online_replay(_storm_cfg(), _storm(),
                       PriorityTrace("random", 0.5, seed=13),
                       model=engine_model)
    assert a._token_hist_by_conv == b._token_hist_by_conv
    assert a.metrics.total_tokens == b.metrics.total_tokens


def test_abort_mid_storm_leaves_survivors_bit_exact(engine_model):
    """Cancelling one conversation mid-storm must not perturb any OTHER
    conversation's greedy tokens: the survivors stay bit-identical to
    the no-abort run (cancellation releases blocks/swaps cleanly instead
    of corrupting neighbours)."""
    base = _online_replay(_storm_cfg(), _storm(),
                          PriorityTrace("random", 0.5, seed=13),
                          model=engine_model)
    ab = _online_replay(_storm_cfg(), _storm(),
                        PriorityTrace("random", 0.5, seed=13),
                        model=engine_model, abort_at=(10, 1))
    assert ab.metrics.aborted == 1
    survivors = {cid: h for cid, h in ab._token_hist_by_conv.items()
                 if cid != 2}
    assert survivors, "no survivor finished a turn"
    for cid, hist in survivors.items():
        assert hist == base._token_hist_by_conv[cid], \
            f"conv {cid} diverged after conv 2 was aborted"


def test_recompute_resume_chunked_parity(engine_model):
    """The recompute-mode resume
    runs through the chunked prefill state machine — and stays
    bit-identical to the monolithic re-prefill, with exactly one first
    token per turn (a resume completion must NOT re-emit one)."""
    from dataclasses import replace

    from repro_torch.core.policies import POLICIES

    def run(chunk):
        pol = replace(POLICIES["vllm-recompute"],
                      chunked_prefill_tokens=chunk)
        cfg = EngineConfig(mode="real", num_gpu_blocks=8,
                           num_cpu_blocks=256, max_running=4, max_batch=4,
                           block_size=16, policy=pol)
        eng = FastSwitchEngine(cfg, _storm(),
                               trace=PriorityTrace("random", 0.5, seed=13),
                               model_bundle=engine_model)
        eng.run(max_iterations=20_000)
        assert eng.done()
        return eng

    mono, chunked = run(0), run(16)
    assert mono.metrics.preemptions > 0, "storm never preempted"
    # the resumes really ran chunked (more chunk launches than prefills)
    st = chunked.runner.stats
    assert st.prefill_chunks > st.prefills, "resume never actually chunked"
    assert mono._token_hist_by_conv == chunked._token_hist_by_conv, \
        "chunked recompute-resume diverged from monolithic re-prefill"
    n_turns = sum(len(c.turns) for c in _storm())
    assert len(chunked.metrics.ttfts_us) == n_turns, \
        "resume completion re-emitted a first token"


def test_continue_session_open_world_real_streams_tokens(engine_model):
    """Open-world two-turn session with client-supplied prompt ids:
    streamed token deltas must reassemble into exactly the greedy
    straight-line reference (prefill + paged decode, no engine)."""
    from repro_torch.cache.paged import PagedPools, PoolSpec
    from repro_torch.models.paged import paged_decode_step, prefill_kv
    cfg_m, params = engine_model["cfg"], engine_model["params"]
    bs = 16
    turns = [(12, 6), (9, 5)]
    prompts = [synth_prompt_ids(7, i, n, cfg_m.vocab_size)
               for i, (n, _) in enumerate(turns)]

    # straight-line greedy reference
    pools = PagedPools(PoolSpec.from_config(cfg_m, 64, 64, bs),
                       device="cpu")
    ref = []
    with torch.no_grad():
        for (n_p, n_r), prompt in zip(turns, prompts):
            ref.extend(prompt)
            logits, k, v = prefill_kv(params, torch.tensor([ref]),
                                      cfg=cfg_m)
            nblk = (len(ref) + bs - 1) // bs
            pools.write_tokens(list(range(nblk)), 0, k, v)
            ref.append(int(torch.argmax(logits)))
            for _ in range(n_r - 1):
                ctx = len(ref) - 1
                bt = torch.tensor([list(range(ctx // bs + 1))],
                                  dtype=torch.int32)
                nxt, _, pools.gpu = paged_decode_step(
                    params, pools.gpu, bt,
                    torch.tensor([ctx], dtype=torch.int32),
                    torch.tensor([ref[-1]], dtype=torch.int32), cfg=cfg_m)
                ref.append(int(nxt[0]))

    cfg = EngineConfig(mode="real", num_gpu_blocks=64, num_cpu_blocks=256,
                       max_running=4, max_batch=4,
                       block_size=bs).with_policy("fastswitch")
    eng = ServingEngine(cfg, trace=PriorityTrace("random", 1e-9, seed=0),
                        model_bundle=engine_model, stream_tokens=True)
    streamed = []
    h = eng.add_request(prompts[0], SamplingParams(max_tokens=turns[0][1]),
                        handle=7, retain_kv=True)
    for out in _drain(eng):
        streamed.extend(out.token_ids or [])
    eng.continue_session(h, prompts[1],
                         SamplingParams(max_tokens=turns[1][1]))
    for out in _drain(eng):
        streamed.extend(out.token_ids or [])
    eng.shutdown()
    # the engine-side full history is bit-exact with the reference
    hist = eng._token_hist_by_conv[h]
    assert hist == ref, "open-world session diverged from reference"
    n0 = len(prompts[0])
    expect = hist[n0:n0 + turns[0][1]] \
        + hist[n0 + turns[0][1] + len(prompts[1]):]
    assert streamed == expect, "streamed deltas != generated tokens"


# ---------------------------------------------------------------------------
# both packages, the same scenarios
# ---------------------------------------------------------------------------


def test_online_client_sim_matches_reference():
    """The sim driver-equivalence scenario's online client, request 1
    aborted at iteration 10, through both packages: the same summary,
    latencies, swap traffic, event log and SLO summary."""
    cfg = EngineConfig(mode="sim", num_gpu_blocks=256, num_cpu_blocks=1024,
                       max_running=8).with_policy("fastswitch")
    ours = _online_replay(cfg, sample_conversations(15, rate_req_s=2.0,
                                                    seed=3),
                          PriorityTrace("markov", 0.04, seed=7),
                          abort_at=(10, 1))
    jcfg = JaxEngineConfig(mode="sim", num_gpu_blocks=256,
                           num_cpu_blocks=1024,
                           max_running=8).with_policy("fastswitch")
    ref = _online_replay(jcfg, jax_sharegpt.sample_conversations(
        15, rate_req_s=2.0, seed=3),
        jax_priority.PriorityTrace("markov", 0.04, seed=7),
        abort_at=(10, 1), api=_reference_api())
    assert ours.metrics.aborted == ref.metrics.aborted == 1
    assert_sim_equal(ours, ref)
    assert ours.metrics.slo_summary() == ref.metrics.slo_summary()


def test_online_client_real_storm_matches_reference(swaps_follow_the_clock):
    """The real storm of ``test_abort_mid_storm_leaves_survivors_bit_exact``
    (conversation 2 aborted at iteration 6) through both packages' online
    clients, held to the simulated clock: the same modelled metrics, and
    every history equal or first different at a near-tie."""
    jb, tb = smoke_bundles()

    def storm(mod):
        return [mod.Conversation(conv_id=i, arrival_s=0.0,
                                 turns=[mod.Turn(16, 10), mod.Turn(8, 6)],
                                 think_time_s=0.2) for i in range(4)]

    def cfg(cls):
        return cls(mode="real", num_gpu_blocks=8, num_cpu_blocks=256,
                   max_running=4, max_batch=4, block_size=16,
                   swap_chunk_blocks=1).with_policy("fastswitch")
    from repro_torch.data import sharegpt
    ours = _online_replay(cfg(EngineConfig), storm(sharegpt),
                          PriorityTrace("random", 0.5, seed=13), model=tb,
                          abort_at=(6, 2))
    ref = _online_replay(cfg(JaxEngineConfig), storm(jax_sharegpt),
                         jax_priority.PriorityTrace("random", 0.5, seed=13),
                         model=jb, abort_at=(6, 2), api=_reference_api())
    assert ours.metrics.aborted == ref.metrics.aborted == 1
    got, want = ours.metrics.summary(), ref.metrics.summary()
    got.pop("callstack_wall_s")
    want.pop("callstack_wall_s")
    assert got == want
    assert [e.as_dict() for e in ours.events] == \
        [e.as_dict() for e in ref.events]
    assert_histories_agree(tb, ours._token_hist_by_conv,
                           ref._token_hist_by_conv)
