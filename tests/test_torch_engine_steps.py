"""The port's serving engine end to end (sim and real modes): the cases
of ``tests/test_engine.py`` against ``repro_torch.core``, and each mode's
scenario run through both packages.  (``tests/test_torch_engine.py``
holds the engine's earlier parity checks; ``tests/`` has no
``__init__.py``, so this file takes another basename.)"""
import pytest

from repro.core import EngineConfig as JaxEngineConfig
from repro.core import FastSwitchEngine as JaxFastSwitchEngine
from repro.data import priority as jax_priority
from repro.data import sharegpt as jax_sharegpt
from repro_torch.core import EngineConfig, FastSwitchEngine
from repro_torch.core.swap_manager import SwapTask
from repro_torch.data.priority import PriorityTrace
from repro_torch.data.sharegpt import Conversation, Turn, sample_conversations
from test_torch_serve import swaps_follow_the_clock  # noqa: F401
from torch_parity import (assert_histories_agree, assert_sim_equal,
                          smoke_bundles)
from torch_threads import one_torch_thread  # noqa: F401


def _engine(policy, convs, mode="sim", **kw):
    model_bundle = kw.pop("model_bundle", None)
    defaults = dict(mode=mode, num_gpu_blocks=512, num_cpu_blocks=4096,
                    max_running=16)
    defaults.update(kw)
    cfg = EngineConfig(**defaults).with_policy(policy)
    return FastSwitchEngine(
        cfg, [c for c in convs],
        trace=PriorityTrace("markov", update_freq=0.04, seed=7),
        model_bundle=model_bundle)


CONVS = sample_conversations(40, rate_req_s=2.0, seed=3)
TOTAL_RESP = sum(t.response_tokens for c in CONVS for t in c.turns)


@pytest.mark.parametrize("policy", ["vllm", "+dbg", "+dbg+reuse",
                                    "fastswitch"])
def test_all_tokens_served(policy):
    eng = _engine(policy, CONVS)
    m = eng.run(max_iterations=300_000)
    assert eng.done()
    assert m.total_tokens == TOTAL_RESP
    assert len(m.ttfts_us) == sum(len(c.turns) for c in CONVS)


def test_determinism():
    m1 = _engine("fastswitch", CONVS).run(max_iterations=300_000)
    m2 = _engine("fastswitch", CONVS).run(max_iterations=300_000)
    assert m1.total_time_us == m2.total_time_us
    assert m1.ttfts_us == m2.ttfts_us


def test_block_groups_reduce_ops():
    e1 = _engine("vllm", CONVS)
    e1.run(max_iterations=300_000)
    e2 = _engine("+dbg", CONVS)
    e2.run(max_iterations=300_000)
    s1, s2 = e1.swap.stats(), e2.swap.stats()
    assert s1["total_ops"] == s1["total_blocks"]       # per-block baseline
    assert s2["total_ops"] < s1["total_ops"] / 3       # coarse grouping
    gran = s2["total_blocks"] / max(s2["total_ops"], 1)
    assert gran > 4


def test_reuse_reduces_swap_out_volume():
    """Paper Table 1: the reuse mechanism cuts swap-out blocks (-53%)."""
    e1 = _engine("+dbg", CONVS)
    e1.run(max_iterations=300_000)
    e2 = _engine("+dbg+reuse", CONVS)
    e2.run(max_iterations=300_000)
    assert e2.swap.blocks_by_dir["out"] < 0.6 * e1.swap.blocks_by_dir["out"]


def test_async_reduces_stall():
    e1 = _engine("+dbg+reuse", CONVS)
    e1.run(max_iterations=300_000)
    e2 = _engine("fastswitch", CONVS)
    e2.run(max_iterations=300_000)
    assert e2.swap.total_stall_us < e1.swap.total_stall_us


def test_fastswitch_improves_tail_latency():
    m1 = _engine("vllm", CONVS).run(max_iterations=300_000)
    m2 = _engine("fastswitch", CONVS).run(max_iterations=300_000)
    s1, s2 = m1.summary(), m2.summary()
    assert s2["p999_tbt_ms"] < s1["p999_tbt_ms"]
    assert s2["throughput_tok_s"] > s1["throughput_tok_s"]


def test_gpu_blocks_never_leak():
    eng = _engine("fastswitch", CONVS)
    eng.run(max_iterations=300_000)
    assert eng.done()
    eng.gpu_mgr.check_invariants()
    assert eng.gpu_mgr.free_blocks() == eng.gpu_mgr.num_blocks


def test_conflict_free_decode_blocks():
    """While running, no in-flight swap-in targets a block owned by a
    *different* request (conflicts must have been resolved)."""
    eng = _engine("fastswitch", CONVS)
    for _ in range(3000):
        if eng.done():
            break
        eng.step()
        inflight = {}
        for t in eng.swap.ongoing_swap_in:
            for b in t.gpu_blocks:
                inflight[b] = t.req_id
        for rid in eng.sched.running:
            for b in eng.gpu_mgr.request_block_ids(rid):
                if b in inflight:
                    assert inflight[b] == rid or False, \
                        f"block {b} of running {rid} is swap-in target " \
                        f"of {inflight[b]}"


# ---------------------------------------------------------------------------
# decode-batch desync regressions: preemption/allocation inside
# step 5 must never decode a request whose block table wasn't extended
# ---------------------------------------------------------------------------


def _assert_no_desync(eng):
    """Every running request's context must fit its allocated blocks —
    the invariant the old in-place ``rids.remove`` / bare ``continue``
    paths silently broke."""
    bs = eng.config.block_size
    for rid in eng.sched.running:
        req = eng.sched.requests[rid]
        cap = len(eng.gpu_mgr.request_block_ids(rid)) * bs
        assert req.context_tokens <= cap, (
            f"desync: rid {rid} context {req.context_tokens} "
            f"> block capacity {cap}")


def test_victim_inside_batch_preemption_no_desync():
    """Force an OutOfBlocksError mid-batch whose victim sits EARLIER in
    the decode list than the allocating request: the old code removed the
    victim from the list being iterated, skipping the next request's
    block allocation while still decoding and crediting it."""
    convs = [
        Conversation(conv_id=0, arrival_s=0.0, turns=[Turn(24, 40)],
                     think_time_s=0.1),
        Conversation(conv_id=1, arrival_s=0.030, turns=[Turn(8, 30)],
                     think_time_s=0.1),
        Conversation(conv_id=2, arrival_s=0.035, turns=[Turn(8, 30)],
                     think_time_s=0.1),
    ]
    cfg = EngineConfig(mode="sim", num_gpu_blocks=6, num_cpu_blocks=256,
                       block_size=16).with_policy("vllm")
    trace = PriorityTrace("random", update_freq=1e-9, seed=0)
    # fixed priorities, no rebalances: rid 0 is always the victim and was
    # admitted first, so it sits at the head of the running list
    trace._prio = {0: 0.1, 1: 0.9, 2: 0.5}
    eng = FastSwitchEngine(cfg, convs, trace=trace)
    for _ in range(3000):
        if eng.done():
            break
        eng.step()
        _assert_no_desync(eng)
    assert eng.done()
    assert eng.metrics.preemptions >= 1, \
        "scenario never triggered the victim-inside-batch preemption"
    assert eng.metrics.total_tokens == 100


def test_alloc_failure_without_victim_skips_decode():
    """OutOfBlocksError with no preemptable victim: the old code's bare
    ``continue`` left the request in the decode set, advancing its
    context past its block table; it must sit the iteration out."""
    convs = [
        Conversation(conv_id=0, arrival_s=0.0, turns=[Turn(8, 20)],
                     think_time_s=0.1),
        Conversation(conv_id=1, arrival_s=0.0, turns=[Turn(8, 20)],
                     think_time_s=0.1),
    ]
    cfg = EngineConfig(mode="sim", num_gpu_blocks=4, num_cpu_blocks=256,
                       block_size=16).with_policy("vllm")
    trace = PriorityTrace("random", update_freq=1e-9, seed=0)
    trace._prio = {0: 0.9, 1: 0.5}
    eng = FastSwitchEngine(cfg, convs, trace=trace)
    eng.core._find_victim = lambda exclude: None   # nobody to preempt
    for _ in range(3000):
        if eng.done():
            break
        eng.step()
        _assert_no_desync(eng)
    assert eng.done()
    assert eng.metrics.total_tokens == 40


def test_emit_first_token_full_pool_routes_through_preemption():
    """A rebalance-time admission can land ``_emit_first_token`` on a full
    pool; the old unguarded ``allocate_tokens`` raised OutOfBlocksError
    out of ``step()`` — it must preempt a victim instead."""
    convs = [
        Conversation(conv_id=0, arrival_s=0.0, turns=[Turn(4, 20)],
                     think_time_s=0.1),
        Conversation(conv_id=1, arrival_s=0.0, turns=[Turn(4, 20)],
                     think_time_s=0.1),
    ]
    cfg = EngineConfig(mode="sim", num_gpu_blocks=4, num_cpu_blocks=256,
                       block_size=8).with_policy("vllm")
    trace = PriorityTrace("random", update_freq=1e-9, seed=0)
    trace._prio = {0: 0.9, 1: 0.5}
    eng = FastSwitchEngine(cfg, convs, trace=trace)
    eng.step()
    assert sorted(eng.sched.running) == [0, 1]
    # exhaust the pool: hand the free block to rid 1, fill rid 0's block
    req0, req1 = eng.sched.requests[0], eng.sched.requests[1]
    eng.gpu_mgr.allocate_tokens(1, 8)
    eng.gpu_mgr.note_tokens(1, 8)
    req1.context_tokens += 8
    fill = 8 - (req0.context_tokens % 8)
    eng.gpu_mgr.allocate_tokens(0, fill)
    eng.gpu_mgr.note_tokens(0, fill)
    req0.context_tokens += fill
    assert eng.gpu_mgr.free_blocks() == 0
    eng._emit_first_token(0)                     # must not raise
    assert eng.metrics.preemptions == 1
    assert 1 not in eng.sched.running
    cap = len(eng.gpu_mgr.request_block_ids(0)) * 8
    assert req0.context_tokens <= cap


def test_swap_out_never_claims_unwritten_last_slot():
    """At swap-out, position context-1's KV has NOT been written yet (the
    next decode step writes its input's K/V before attending).  The old
    code marked it valid in the CPU reuse copy: the incremental copy
    never revisits slots behind its pointer, so a preemption at a
    block-aligned context froze garbage into the copy and a later
    swap-in restored it into attended positions (token corruption)."""
    convs = [Conversation(conv_id=0, arrival_s=0.0, turns=[Turn(8, 30)],
                          think_time_s=0.1)]
    cfg = EngineConfig(mode="sim", num_gpu_blocks=64, num_cpu_blocks=256,
                       block_size=16).with_policy("fastswitch")
    eng = FastSwitchEngine(cfg, convs,
                           trace=PriorityTrace("random", 1e-9, seed=0))
    for _ in range(5):
        eng.step()
    req = eng.sched.requests[0]
    assert 0 in eng.sched.running and req.context_tokens > 1
    eng._preempt(0)
    assert eng.reuse.valid_tokens(0) == req.context_tokens - 1, \
        "swap-out claimed the unwritten last KV slot as valid"


def test_swapping_in_promoted_after_conflict_sync():
    """A fine-grained conflict sync (resolve_conflicts) retires an async
    swap-in task between step-1 polls; the old engine never promoted the
    request out of SWAPPING_IN — it was stranded forever (livelock)."""
    convs = [Conversation(conv_id=0, arrival_s=0.0, turns=[Turn(8, 20)],
                          think_time_s=0.1)]
    cfg = EngineConfig(mode="sim", num_gpu_blocks=64, num_cpu_blocks=256,
                       block_size=16).with_policy("fastswitch")
    eng = FastSwitchEngine(cfg, convs,
                           trace=PriorityTrace("random", 1e-9, seed=0))
    eng.swap.adaptive = False     # force async: the cost model would pick
    eng.step()                    # sync for a 1-block swap on an idle batch
    assert 0 in eng.sched.running
    eng._preempt(0)
    assert 0 in eng.sched.swapped
    assert eng._swap_in(0) is False          # async: in flight
    assert 0 in eng.sched.swapping_in
    task = eng.swap.ongoing_swap_in[0]
    # conflict on a target block synchronizes the task away
    eng.swap.resolve_conflicts(eng.clock, list(task.gpu_blocks)[:1])
    assert eng.swap.ongoing_swap_in == []
    eng.step()
    assert 0 in eng.sched.running, "request stranded in SWAPPING_IN"


def test_emit_first_token_resolves_swap_conflicts_on_new_block():
    """The first-token block can be a just-freed block that an in-flight
    async swap-out is still reading; _emit_first_token must synchronize
    exactly like step 5 does for newly allocated decode blocks."""
    convs = [Conversation(conv_id=0, arrival_s=0.0, turns=[Turn(4, 20)],
                          think_time_s=0.1)]
    cfg = EngineConfig(mode="sim", num_gpu_blocks=8, num_cpu_blocks=256,
                       block_size=8).with_policy("fastswitch")
    eng = FastSwitchEngine(cfg, convs,
                           trace=PriorityTrace("random", 1e-9, seed=0))
    eng.step()
    req0 = eng.sched.requests[0]
    # advance to the block boundary so the next token needs a fresh block
    fill = 8 - (req0.context_tokens % 8)
    eng.gpu_mgr.allocate_tokens(0, fill)
    eng.gpu_mgr.note_tokens(0, fill)
    req0.context_tokens += fill
    # fabricate an in-flight swap-out reading every block
    now = eng.clock.now_us
    task = SwapTask(req_id=99, direction="out", n_ops=1, n_blocks=1,
                    bytes_total=1, issued_at=now, done_at=now + 5000.0,
                    gpu_blocks=set(range(cfg.num_gpu_blocks)))
    eng.swap.ongoing_swap_out.append(task)
    n0 = eng.swap.n_conflicts
    eng._emit_first_token(0)
    assert eng.swap.n_conflicts == n0 + 1, \
        "first-token block allocated without synchronizing the conflict"
    assert eng.clock.now_us >= task.done_at


# ---------------------------------------------------------------------------
# real mode: actual tokens through the paged pool
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_model():
    """The reduced qwen2-1.5b with the reference fixture's weights."""
    return smoke_bundles()[1]


def test_real_mode_generates_exact_token_count(tiny_model):
    convs = [Conversation(conv_id=i, arrival_s=0.05 * i,
                          turns=[Turn(10, 6), Turn(8, 6)], think_time_s=0.3)
             for i in range(3)]
    eng = _engine("fastswitch", convs, mode="real", num_gpu_blocks=64,
                  num_cpu_blocks=256, max_running=4, max_batch=4,
                  model_bundle=tiny_model)
    m = eng.run(max_iterations=20_000)
    assert eng.done()
    assert m.total_tokens == 3 * 2 * 6


def test_real_mode_swap_preserves_tokens(tiny_model):
    """Same conversations, severe preemption (tiny pool, frequent priority
    updates) vs none: generated token streams must be IDENTICAL — context
    switching must not corrupt KV."""
    def mk():
        return [Conversation(conv_id=i, arrival_s=0.0,
                             turns=[Turn(16, 24)], think_time_s=0.2)
                for i in range(4)]

    def run(gpu_blocks, freq):
        cfg = EngineConfig(mode="real", num_gpu_blocks=gpu_blocks,
                           num_cpu_blocks=512, max_running=4,
                           max_batch=4).with_policy("fastswitch")
        eng = FastSwitchEngine(
            cfg, mk(), trace=PriorityTrace("random", freq, seed=11),
            model_bundle=tiny_model)
        eng.run(max_iterations=20_000)
        assert eng.done()
        hists = {}
        for c in eng.sleeping:
            pass
        return eng

    e_calm = run(gpu_blocks=256, freq=0.0001)      # virtually no preemption
    e_storm = run(gpu_blocks=8, freq=0.5)          # heavy context switching
    assert e_storm.metrics.preemptions > e_calm.metrics.preemptions
    # compare token histories recorded per conversation
    calm = e_calm._token_hist_by_conv
    storm = e_storm._token_hist_by_conv
    assert set(calm) == set(storm)
    for cid in calm:
        assert calm[cid] == storm[cid], f"conv {cid} tokens diverged"


# ---------------------------------------------------------------------------
# both packages, the same scenarios
# ---------------------------------------------------------------------------


def _jax_engine(policy, convs, mode="sim", **kw):
    model_bundle = kw.pop("model_bundle", None)
    defaults = dict(mode=mode, num_gpu_blocks=512, num_cpu_blocks=4096,
                    max_running=16)
    defaults.update(kw)
    cfg = JaxEngineConfig(**defaults).with_policy(policy)
    return JaxFastSwitchEngine(
        cfg, list(convs),
        trace=jax_priority.PriorityTrace("markov", update_freq=0.04, seed=7),
        model_bundle=model_bundle)


def test_sim_run_matches_reference():
    """``CONVS`` under the fastswitch policy through both packages: the
    same summary, latencies and swap traffic."""
    ref_convs = jax_sharegpt.sample_conversations(40, rate_req_s=2.0,
                                                  seed=3)
    ref = _jax_engine("fastswitch", ref_convs)
    ref.run(max_iterations=300_000)
    ours = _engine("fastswitch", CONVS)
    ours.run(max_iterations=300_000)
    assert ours.done() and ref.done()
    assert_sim_equal(ours, ref)
    ref.swap.shutdown()
    ours.swap.shutdown()


def test_real_storm_matches_reference(swaps_follow_the_clock):
    """The storm of ``test_real_mode_swap_preserves_tokens`` (8 GPU
    blocks, priorities redrawn every other iteration) through both
    packages, both held to the simulated clock: the same modelled
    metrics, and greedy histories equal or first different at a
    near-tie."""
    jb, tb = smoke_bundles()

    def convs(mod):
        return [mod.Conversation(conv_id=i, arrival_s=0.0,
                                 turns=[mod.Turn(16, 24)], think_time_s=0.2)
                for i in range(4)]

    def cfg(cls):
        return cls(mode="real", num_gpu_blocks=8, num_cpu_blocks=512,
                   max_running=4, max_batch=4).with_policy("fastswitch")
    from repro_torch.data import sharegpt
    ref = JaxFastSwitchEngine(
        cfg(JaxEngineConfig), convs(jax_sharegpt),
        trace=jax_priority.PriorityTrace("random", 0.5, seed=11),
        model_bundle=jb)
    ref.run(max_iterations=20_000)
    ours = FastSwitchEngine(cfg(EngineConfig), convs(sharegpt),
                            trace=PriorityTrace("random", 0.5, seed=11),
                            model_bundle=tb)
    ours.run(max_iterations=20_000)
    assert ours.done() and ref.done()
    assert ours.metrics.preemptions > 0
    want, got = ref.metrics.summary(), ours.metrics.summary()
    want.pop("callstack_wall_s")
    got.pop("callstack_wall_s")
    assert got == want
    assert_histories_agree(tb, ours._token_hist_by_conv,
                           ref._token_hist_by_conv)
