"""Cancellation correctness in the port (``repro_torch.core.serving``):
``abort()`` at any point in any lifecycle state never leaks GPU/CPU
blocks, never strands a swap task, and leaves decode-runner rows clean
(trash-sentinel block table) — the cases of
``tests/test_abort_properties.py``, and an abort schedule run through
both packages.

Two layers:
  * a deterministic per-state unit matrix — one scenario per lifecycle
    state (WAITING, RUNNING, SWAPPED, SWAPPING_IN, mid-chunked-prefill,
    recompute-WAITING-resume, FINISHED/retained), sim + real;
  * a hypothesis property — random conversations, random priority storm,
    random abort schedule, across policies — end state must be fully
    reclaimed.
"""
import numpy as np
import pytest

from repro.core import EngineConfig as JaxEngineConfig
from repro.core import SamplingParams as JaxSamplingParams
from repro.core import ServingEngine as JaxServingEngine
from repro.data import priority as jax_priority
from repro_torch.core import (EngineConfig, SamplingParams, ServingEngine,
                              SLOSpec)
from repro_torch.core.scheduler import ReqState
from repro_torch.data.priority import PriorityTrace
from test_torch_serve import swaps_follow_the_clock  # noqa: F401
from torch_parity import (assert_histories_agree, assert_sim_equal,
                          smoke_bundles)
from torch_threads import one_torch_thread  # noqa: F401

# the deterministic per-state matrix runs everywhere; only the random
# schedule property needs hypothesis (installed via requirements-dev.txt)
try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                 # pragma: no cover
    HAVE_HYPOTHESIS = False


def _engine(policy="fastswitch", reference=False, **kw):
    """A sim engine of the port, or with ``reference`` of the reference."""
    engine_cls, cfg_cls, trace_cls = (
        (JaxServingEngine, JaxEngineConfig, jax_priority.PriorityTrace)
        if reference else (ServingEngine, EngineConfig, PriorityTrace))
    trace = kw.pop("trace", None) or trace_cls("random", 1e-9, seed=0)
    defaults = dict(mode="sim", num_gpu_blocks=64, num_cpu_blocks=256,
                    block_size=16, max_running=8)
    defaults.update(kw)
    return engine_cls(cfg_cls(**defaults).with_policy(policy), trace=trace)


def _assert_request_gone(eng, h):
    assert h not in eng.sched.requests
    assert h not in eng.parked
    for q in (eng.sched.waiting, eng.sched.running, eng.sched.swapped,
              eng.sched.swapping_in):
        assert h not in q
    assert eng.gpu_mgr.request_block_ids(h) == []
    assert eng.reuse.mgr.request_block_ids(h) == []
    assert eng.reuse.valid_tokens(h) == 0
    assert all(t.req_id != h for t in eng.swap.ongoing_swap_in), \
        "stranded swap-in task"
    eng.gpu_mgr.check_invariants()
    eng.reuse.mgr.check_invariants()


def _assert_fully_reclaimed(eng):
    """With no live or retained requests, every block is free and every
    swap task retired."""
    # in-flight async swap-outs retire on their own timeline; drain them
    eng.clock.advance(1e9)
    eng.swap.synchronize(eng.clock, list(eng.swap.ongoing_swap_in)
                         + list(eng.swap.ongoing_swap_out))
    eng.swap.poll_completed(eng.clock)
    assert eng.gpu_mgr.free_blocks() == eng.gpu_mgr.num_blocks, \
        "leaked GPU blocks"
    assert eng.reuse.mgr.free_blocks() == eng.reuse.mgr.num_blocks, \
        "leaked CPU blocks"
    assert not eng.swap.ongoing_swap_in and not eng.swap.ongoing_swap_out, \
        "stranded swap task"
    eng.gpu_mgr.check_invariants()
    eng.reuse.mgr.check_invariants()


# ---------------------------------------------------------------------------
# deterministic per-state matrix (sim)
# ---------------------------------------------------------------------------


def test_abort_waiting():
    eng = _engine()
    h = eng.add_request(8, SamplingParams(max_tokens=4))
    assert eng._req(h).state == ReqState.WAITING
    assert eng.abort(h) is True
    _assert_request_gone(eng, h)
    _assert_fully_reclaimed(eng)
    eng.shutdown()


def test_abort_running():
    eng = _engine()
    h = eng.add_request(8, SamplingParams(max_tokens=40))
    eng.step()
    assert eng._req(h).state == ReqState.RUNNING
    assert eng.abort(h) is True
    _assert_request_gone(eng, h)
    _assert_fully_reclaimed(eng)
    eng.shutdown()


def test_abort_swapped():
    eng = _engine()
    h = eng.add_request(8, SamplingParams(max_tokens=40))
    eng.step()
    eng._preempt(h)
    assert eng._req(h).state == ReqState.SWAPPED
    assert eng.reuse.valid_tokens(h) > 0     # CPU copy exists pre-abort
    assert eng.abort(h) is True
    _assert_request_gone(eng, h)
    _assert_fully_reclaimed(eng)
    eng.shutdown()


def test_abort_swapping_in_mid_flight():
    eng = _engine()
    eng.swap.adaptive = False        # force async swaps
    h = eng.add_request(8, SamplingParams(max_tokens=40))
    eng.step()
    eng._preempt(h)
    assert eng._swap_in(h) is False  # async: in flight
    assert eng._req(h).state == ReqState.SWAPPING_IN
    assert any(t.req_id == h for t in eng.swap.ongoing_swap_in)
    assert eng.abort(h) is True
    _assert_request_gone(eng, h)
    _assert_fully_reclaimed(eng)
    eng.shutdown()


def test_abort_mid_chunked_prefill_sim():
    eng = _engine("fastswitch+chunked", num_gpu_blocks=128)
    h = eng.add_request(600, SamplingParams(max_tokens=4))
    eng.step()
    req = eng._req(h)
    assert req.state == ReqState.RUNNING and req.prefill_remaining > 0, \
        "scenario never entered chunked prefill"
    assert eng.abort(h) is True
    _assert_request_gone(eng, h)
    _assert_fully_reclaimed(eng)
    eng.shutdown()


def test_abort_mid_chunked_resume_recompute_sim():
    """Recompute preemption of a long request resumes through the
    chunked state machine (``prefill_is_resume``); aborting MID-resume
    must reclaim everything like any other state."""
    from dataclasses import replace

    from repro_torch.core.policies import POLICIES
    pol = replace(POLICIES["vllm-recompute"], chunked_prefill_tokens=16)
    eng = ServingEngine(
        EngineConfig(mode="sim", num_gpu_blocks=64, num_cpu_blocks=256,
                     block_size=16, max_running=8, policy=pol),
        trace=PriorityTrace("random", 1e-9, seed=0))
    h = eng.add_request(60, SamplingParams(max_tokens=40))
    for _ in range(8):                 # finish the chunked fresh prefill
        eng.step()
    req = eng._req(h)
    assert req.prefill_remaining == 0 and req.generated > 0
    eng._preempt(h)
    assert req.state == ReqState.WAITING and req.resume_tokens > 16
    eng.step()                         # re-admit -> chunked resume opens
    assert req.prefill_remaining > 0 and req.prefill_is_resume, \
        "resume did not enter the chunked state machine"
    assert eng.abort(h) is True
    _assert_request_gone(eng, h)
    _assert_fully_reclaimed(eng)
    eng.shutdown()


def test_abort_recompute_waiting_resume():
    eng = _engine("vllm-recompute")
    h = eng.add_request(8, SamplingParams(max_tokens=40))
    eng.step()
    eng._preempt(h)
    req = eng._req(h)
    assert req.state == ReqState.WAITING and req.resume_tokens > 0
    assert eng.abort(h) is True
    _assert_request_gone(eng, h)
    _assert_fully_reclaimed(eng)
    eng.shutdown()


def test_abort_finished_retained_session():
    eng = _engine()
    h = eng.add_request(8, SamplingParams(max_tokens=3), retain_kv=True)
    while eng.has_work():
        eng.step()
    assert h in eng.parked and eng.reuse.valid_tokens(h) > 0
    assert eng.abort(h) is True
    _assert_request_gone(eng, h)
    _assert_fully_reclaimed(eng)
    eng.shutdown()


def test_abort_unknown_handle_is_noop():
    eng = _engine()
    assert eng.abort(999) is False
    eng.shutdown()


def test_abort_emits_output_and_event():
    eng = _engine()
    h = eng.add_request(8, SamplingParams(max_tokens=40),
                        slo=SLOSpec(ttft_ms=1e6))
    eng.step()
    eng.abort(h)
    outs = eng.step()        # the abort's output rides the next step
    fin = [o for o in outs if o.handle == h and o.finished]
    assert len(fin) == 1 and fin[0].finish_reason == "abort"
    assert [e.kind for e in eng.events if e.handle == h][-1] == "abort"
    # the partial turn still contributed an SLO attainment record
    assert any(s.handle == h and s.finish_reason == "abort"
               for s in eng.metrics.request_stats)
    assert eng.metrics.aborted == 1
    eng.shutdown()


# ---------------------------------------------------------------------------
# deterministic per-state matrix (real mode: runner-row sentinel checks)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_model():
    """The reduced qwen2-1.5b with the reference fixture's weights."""
    return smoke_bundles()[1]


def _real_engine(tiny_model, policy="fastswitch", **kw):
    defaults = dict(mode="real", num_gpu_blocks=64, num_cpu_blocks=256,
                    block_size=16, max_running=4, max_batch=4)
    defaults.update(kw)
    return ServingEngine(EngineConfig(**defaults).with_policy(policy),
                         trace=PriorityTrace("random", 1e-9, seed=0),
                         model_bundle=tiny_model)


def _ids(n, vocab, seed=0):
    return np.random.RandomState(seed).randint(1, vocab, size=n).tolist()


def _assert_runner_row_clean(eng, h, row):
    """Sentinel check: the freed row's block table points only at the
    trash block, its context is zeroed and it is masked inactive."""
    assert h not in eng.runner._rows
    bt = np.asarray(eng.runner._bt)
    assert np.all(bt[row] == eng._trash_block), \
        f"freed row {row} still maps real blocks: {bt[row]}"
    assert int(np.asarray(eng.runner._ctx)[row]) == 0
    assert not bool(np.asarray(eng.runner._active)[row])


def test_abort_running_real_frees_runner_row(tiny_model):
    vocab = tiny_model["cfg"].vocab_size
    eng = _real_engine(tiny_model)
    h1 = eng.add_request(_ids(10, vocab, 1), SamplingParams(max_tokens=30))
    h2 = eng.add_request(_ids(10, vocab, 2), SamplingParams(max_tokens=30))
    for _ in range(4):
        eng.step()
    assert eng._req(h1).state == ReqState.RUNNING
    row = eng.runner._rows[h1]
    assert eng.abort(h1) is True
    _assert_request_gone(eng, h1)
    _assert_runner_row_clean(eng, h1, row)
    # the surviving request keeps decoding to completion
    while eng.has_work():
        eng.step()
    assert eng.metrics.total_tokens >= 30
    _assert_fully_reclaimed(eng)
    eng.shutdown()


def test_abort_mid_chunked_prefill_real(tiny_model):
    from dataclasses import replace

    from repro_torch.core.policies import POLICIES
    vocab = tiny_model["cfg"].vocab_size
    pol = replace(POLICIES["fastswitch"], chunked_prefill_tokens=16)
    eng = ServingEngine(
        EngineConfig(mode="real", num_gpu_blocks=64, num_cpu_blocks=256,
                     block_size=16, max_running=4, max_batch=4, policy=pol),
        trace=PriorityTrace("random", 1e-9, seed=0),
        model_bundle=tiny_model)
    h = eng.add_request(_ids(80, vocab, 3), SamplingParams(max_tokens=4))
    eng.step()
    req = eng._req(h)
    assert req.prefill_remaining > 0, "never entered chunked prefill"
    assert h in eng.runner._prefills
    assert eng.abort(h) is True
    assert h not in eng.runner._prefills, "stranded prefill carry"
    _assert_request_gone(eng, h)
    _assert_fully_reclaimed(eng)
    eng.shutdown()


def test_abort_swapping_real_mid_swap_chunks(tiny_model):
    """Abort while the request's staged swap-in chunk tasks are still in
    flight: chunks retire, blocks free, and a NEW request can
    immediately claim the pool without corruption."""
    vocab = tiny_model["cfg"].vocab_size
    eng = _real_engine(tiny_model, swap_chunk_blocks=1)
    eng.swap.adaptive = False                  # force async
    h = eng.add_request(_ids(40, vocab, 4), SamplingParams(max_tokens=30))
    for _ in range(3):
        eng.step()
    eng._preempt(h)
    assert eng._swap_in(h) is False
    assert any(t.req_id == h for t in eng.swap.ongoing_swap_in)
    assert eng.abort(h) is True
    _assert_request_gone(eng, h)
    # fresh request takes over the freed pool and runs clean
    h2 = eng.add_request(_ids(12, vocab, 5), SamplingParams(max_tokens=6))
    while eng.has_work():
        eng.step()
    assert eng._token_hist_by_conv[h2][-6:], "successor never decoded"
    _assert_fully_reclaimed(eng)
    eng.shutdown()


# ---------------------------------------------------------------------------
# hypothesis: random abort schedule across policies and storms
# ---------------------------------------------------------------------------


def _run_random_abort_schedule(seed, policy, n_req, storm_freq,
                               n_aborts, abort_iters, reference=False):
    """Abort random requests at random iterations under a random
    priority storm: whatever lifecycle state each abort lands in, the
    end state is fully reclaimed (no block leaks, no stranded tasks,
    clean pool-manager invariants).  Returns the engine (shut down);
    with ``reference``, the reference's."""
    rng = np.random.RandomState(seed)
    trace_cls, sp_cls = ((jax_priority.PriorityTrace, JaxSamplingParams)
                         if reference else (PriorityTrace, SamplingParams))
    eng = _engine(policy, reference, num_gpu_blocks=16, num_cpu_blocks=64,
                  trace=trace_cls("random", storm_freq, seed=seed))
    handles = []
    for i in range(n_req):
        handles.append(eng.add_request(
            int(rng.randint(4, 80)),
            sp_cls(max_tokens=int(rng.randint(1, 30))),
            retain_kv=bool(rng.randint(0, 2))))
    abort_iters = sorted(abort_iters)
    to_abort = list(rng.permutation(handles)[:n_aborts])
    it = 0
    while (eng.has_work() or eng.parked) and it < 5000:
        while abort_iters and abort_iters[0] <= it and to_abort:
            abort_iters.pop(0)
            eng.abort(int(to_abort.pop()))
        if eng.has_work():
            eng.step()
        else:       # only parked sessions left: release them
            for h in list(eng.parked):
                eng.release_session(h)
        it += 1
    assert it < 5000, "engine failed to drain"
    for h in handles:
        _assert_request_gone(eng, h)
    _assert_fully_reclaimed(eng)
    eng.shutdown()
    return eng


@pytest.mark.parametrize("seed,policy,storm_freq", [
    (0, "fastswitch", 0.5),
    (1, "fastswitch+chunked", 0.5),
    (2, "vllm-recompute", 0.5),
    (3, "vllm", 1e-9),
])
def test_abort_schedule_fixed_seeds(seed, policy, storm_freq):
    """Deterministic instances of the random-schedule property (runs
    even without hypothesis installed)."""
    _run_random_abort_schedule(seed, policy, n_req=4,
                               storm_freq=storm_freq, n_aborts=2,
                               abort_iters=[1, 7])


if HAVE_HYPOTHESIS:
    def _property(seed, policy, n_req, storm_freq, data):
        n_aborts = data.draw(st.integers(1, n_req), label="n_aborts")
        abort_iters = data.draw(
            st.lists(st.integers(0, 40), min_size=n_aborts,
                     max_size=n_aborts), label="abort_iters")
        _run_random_abort_schedule(seed, policy, n_req, storm_freq,
                                   n_aborts, abort_iters)

    test_abort_any_state_never_leaks = settings(
        max_examples=25, deadline=None)(given(
            seed=st.integers(0, 2 ** 20),
            policy=st.sampled_from(["fastswitch", "fastswitch+chunked",
                                    "vllm", "vllm-recompute"]),
            n_req=st.integers(2, 6),
            storm_freq=st.sampled_from([1e-9, 0.5]),
            data=st.data(),
        )(_property))
else:                                               # pragma: no cover
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_abort_any_state_never_leaks():
        pass


# ---------------------------------------------------------------------------
# both packages, the same scenarios
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,policy", [(0, "fastswitch"),
                                         (1, "fastswitch+chunked")])
def test_abort_schedule_matches_reference(seed, policy):
    """A fixed-seed abort schedule under a storm through both packages:
    the same aborts, metrics, latencies, swap traffic and event log."""
    kw = dict(n_req=5, storm_freq=0.5, n_aborts=3, abort_iters=[1, 4, 9])
    ours = _run_random_abort_schedule(seed, policy, **kw)
    ref = _run_random_abort_schedule(seed, policy, **kw, reference=True)
    assert ours.metrics.aborted == ref.metrics.aborted > 0
    assert_sim_equal(ours, ref)


def test_abort_running_real_matches_reference(tiny_model,
                                              swaps_follow_the_clock):
    """``test_abort_running_real_frees_runner_row``'s scenario through
    both packages: the same event log and modelled metrics, and the
    survivor's greedy history equal or first different at a near-tie."""
    jb, tb = smoke_bundles()

    def run(engine_cls, cfg_cls, trace_cls, sp_cls, bundle):
        vocab = bundle["cfg"].vocab_size
        eng = engine_cls(cfg_cls(mode="real", num_gpu_blocks=64,
                                 num_cpu_blocks=256, block_size=16,
                                 max_running=4, max_batch=4
                                 ).with_policy("fastswitch"),
                         trace=trace_cls("random", 1e-9, seed=0),
                         model_bundle=bundle)
        h1 = eng.add_request(_ids(10, vocab, 1), sp_cls(max_tokens=30))
        eng.add_request(_ids(10, vocab, 2), sp_cls(max_tokens=30))
        for _ in range(4):
            eng.step()
        assert eng.abort(h1) is True
        while eng.has_work():
            eng.step()
        eng.runner.flush()
        eng.shutdown()
        return eng

    ours = run(ServingEngine, EngineConfig, PriorityTrace, SamplingParams,
               tb)
    ref = run(JaxServingEngine, JaxEngineConfig, jax_priority.PriorityTrace,
              JaxSamplingParams, jb)
    assert [e.as_dict() for e in ours.events] == \
        [e.as_dict() for e in ref.events]
    got, want = ours.metrics.summary(), ref.metrics.summary()
    got.pop("callstack_wall_s")
    want.pop("callstack_wall_s")
    assert got == want
    assert_histories_agree(tb, ours._token_hist_by_conv,
                           ref._token_hist_by_conv)
