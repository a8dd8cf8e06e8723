"""The port's KV Cache Reuse Mechanism (``repro_torch.core.reuse``,
FastSwitch §3.3): the cases of ``tests/test_reuse.py``, the same
swap-out sequences through both packages' managers, and the
contamination fault of both packages at the size that shows it: the
port resumes a swap-in over a short copy by restoring its valid prefix
and recomputing the rest, and serves the dense argmax tokens.

Hypothesis is a dev-only dependency (requirements-dev.txt): when it is
absent only the property tests skip — the example-based regressions in
this file still run (they guard engine-behaviour fixes)."""
import os
import sys

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:               # stub the decorators: defs still parse,
    class _NoStrategies:          # the property tests skip individually
        def __getattr__(self, name):
            return lambda *a, **k: None
    st = _NoStrategies()

    def given(*a, **k):
        return lambda fn: pytest.mark.skip(
            reason="hypothesis not installed; see requirements-dev.txt")(fn)

    def settings(*a, **k):
        return lambda fn: fn

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
from repro.core import reuse as jax_reuse  # noqa: E402
from repro_torch.core.reuse import KVCacheReuseManager  # noqa: E402
from torch_parity import assert_sim_equal  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def test_increment_only_transfer():
    r = KVCacheReuseManager(1024, 16, enabled=True)
    r.update_priority(1, 0.5)
    inc, runs = r.record_swap_out(1, 500, requesting_priority=0.5)
    assert inc == 500                       # first swap-out: everything
    assert r.valid_tokens(1) == 500
    # swap in retains the copy
    assert r.record_swap_in(1) == 500
    assert r.valid_tokens(1) == 500
    # next turn grew the context: only the delta moves
    inc2, _ = r.record_swap_out(1, 800, requesting_priority=0.5)
    assert inc2 == 300
    assert r.valid_tokens(1) == 800


def test_disabled_baseline_always_full():
    r = KVCacheReuseManager(4096, 16, enabled=False)
    r.update_priority(1, 0.5)
    inc, _ = r.record_swap_out(1, 500)
    assert inc == 500
    inc, _ = r.record_swap_out(1, 800)
    assert inc == 800                       # baseline re-writes everything
    assert r.record_swap_in(1) == 0         # no reuse accounting


def test_contamination_only_hits_lower_priority():
    r = KVCacheReuseManager(64, 16, enabled=True, prealloc_blocks=0)
    r.update_priority(1, 0.9)               # high priority victim candidate
    r.record_swap_out(1, 64 * 16 - 256, requesting_priority=0.9)
    r.update_priority(2, 0.5)
    # lower-priority requester cannot contaminate the higher-priority copy
    before = r.valid_tokens(1)
    r.record_swap_out(2, 1024, requesting_priority=0.5)
    assert r.valid_tokens(1) == before


def test_contamination_shrinks_victim_prefix():
    r = KVCacheReuseManager(64, 16, enabled=True, prealloc_blocks=0)
    r.update_priority(1, 0.1)               # low priority
    r.record_swap_out(1, 60 * 16, requesting_priority=0.1)
    assert r.valid_tokens(1) == 960
    r.update_priority(2, 0.9)
    inc, _ = r.record_swap_out(2, 30 * 16, requesting_priority=0.9)
    assert inc == 480
    # the victim's copy shrank but never exceeds what is physically stored
    assert r.valid_tokens(1) < 960
    assert r.n_contaminations >= 1
    cap = r.mgr.request_tokens(1)
    assert r.valid_tokens(1) <= cap


@settings(max_examples=80, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 4), st.integers(1, 900),
                          st.floats(0, 1)),
                min_size=1, max_size=30))
def test_valid_prefix_never_exceeds_stored(ops):
    """Property: valid_tokens(r) <= tokens physically allocated on CPU —
    a request can never reuse contaminated/unstored cache."""
    r = KVCacheReuseManager(128, 16, enabled=True, prealloc_blocks=2)
    for rid, tokens, prio in ops:
        r.update_priority(rid, prio)
        r.record_swap_out(rid, tokens, requesting_priority=prio)
        for other in list(r.copies):
            assert r.valid_tokens(other) <= r.mgr.request_tokens(other)
        r.mgr.check_invariants()


def test_release_frees_cpu_space():
    r = KVCacheReuseManager(64, 16, enabled=True, prealloc_blocks=0)
    r.update_priority(1, 0.5)
    r.record_swap_out(1, 500, requesting_priority=0.5)
    used = r.mgr.free_blocks()
    r.release(1)
    assert r.mgr.free_blocks() == 64
    assert r.valid_tokens(1) == 0


def test_disabled_baseline_rewrites_in_place():
    """Regression for the dead-code removal in
    ``_ensure_cpu_tokens``: the disabled-baseline rewrite path re-writes
    the SAME CPU blocks every preemption — the allocation only grows
    with the context, it is never re-acquired (the old ``replace``
    branch recomputed the identical growth)."""
    r = KVCacheReuseManager(4096, 16, enabled=False, prealloc_blocks=0)
    r.update_priority(1, 0.5)
    inc, runs1 = r.record_swap_out(1, 500)
    assert inc == 500
    blocks1 = r.mgr.request_block_ids(1)
    # same-size rewrite: full re-transfer, IDENTICAL allocation
    inc, runs2 = r.record_swap_out(1, 500)
    assert inc == 500
    assert r.mgr.request_block_ids(1) == blocks1
    assert runs2 == runs1
    # growth: the old blocks stay in place, only the tail is appended
    inc, _ = r.record_swap_out(1, 800)
    assert inc == 800
    blocks3 = r.mgr.request_block_ids(1)
    assert blocks3[:len(blocks1)] == blocks1
    assert len(blocks3) == -(-800 // 16)


def test_contamination_victim_prefix_matches_capacity():
    """Invariant: after a contamination the victim's
    ``valid_tokens`` equals the uncontaminated prefix implied by its
    REMAINING CPU capacity minus its (now consumed) preallocation."""
    r = KVCacheReuseManager(64, 16, enabled=True, prealloc_blocks=2)
    r.update_priority(1, 0.1)
    r.record_swap_out(1, 40 * 16, requesting_priority=0.1)
    valid_before = r.valid_tokens(1)
    prealloc_before = r.copies[1].prealloc_tokens
    r.update_priority(2, 0.9)
    r.record_swap_out(2, 30 * 16, requesting_priority=0.9)
    assert r.n_contaminations >= 1
    cap_after = r.mgr.request_tokens(1)
    assert r.valid_tokens(1) == min(
        valid_before, max(0, cap_after - prealloc_before))
    assert r.copies[1].prealloc_tokens == 0


def test_contamination_refuses_equal_priority():
    """Regression: the victim guard used ``>`` — an
    EQUAL-priority victim could be contaminated, letting two peers
    ping-pong each other's prefixes away.  Only strictly-lower-priority
    copies may be reclaimed (paper §2.2)."""
    r = KVCacheReuseManager(64, 16, enabled=True, prealloc_blocks=0)
    r.update_priority(1, 0.5)
    r.record_swap_out(1, 64 * 16 - 256, requesting_priority=0.5)
    before = r.valid_tokens(1)
    r.update_priority(2, 0.5)
    r.record_swap_out(2, 1024, requesting_priority=0.5)
    assert r.valid_tokens(1) == before
    assert r.n_contaminations == 0


def test_contamination_falls_back_to_live_priority():
    """Regression: a victim never seen by ``update_priority``
    defaulted to priority 0.0 and became a preferential contamination
    victim regardless of its true priority.  With ``priority_fn`` wired
    (the engine points it at ``scheduler.priority``) the live priority
    protects it — and a genuinely higher-priority requester still wins."""
    r = KVCacheReuseManager(64, 16, enabled=True, prealloc_blocks=0)
    r.priority_fn = lambda rid: 0.9 if rid == 1 else 0.0
    # rid 1 swaps out WITHOUT any update_priority call
    r.record_swap_out(1, 64 * 16 - 256, requesting_priority=0.9)
    before = r.valid_tokens(1)
    r.update_priority(2, 0.5)
    r.record_swap_out(2, 1024, requesting_priority=0.5)
    assert r.valid_tokens(1) == before      # protected by the fallback
    assert r.n_contaminations == 0
    r.update_priority(3, 0.95)
    r.record_swap_out(3, 512, requesting_priority=0.95)
    assert r.valid_tokens(1) < before
    assert r.n_contaminations >= 1


def test_invalidate_resets_prealloc():
    """Regression (extends the stale-prealloc tests to
    the invalidate path): ``invalidate`` zeroed valid/stored but left
    ``prealloc_tokens`` stale — nothing valid is stored, so nothing can
    be "reserved ahead" of it; the stale reserve made the next
    record_swap_out under-report and a later contamination over-shrink
    the victim's valid prefix."""
    r = KVCacheReuseManager(64, 16, enabled=True, prealloc_blocks=2)
    r.update_priority(1, 0.5)
    r.record_swap_out(1, 20 * 16, requesting_priority=0.5)
    assert r.copies[1].prealloc_tokens == 32
    r.invalidate(1)
    assert r.copies[1].valid_tokens == 0
    assert r.copies[1].stored_tokens == 0
    assert r.copies[1].prealloc_tokens == 0
    # re-swap-out after the failure: full re-transfer, coherent prealloc
    inc, _ = r.record_swap_out(1, 20 * 16, requesting_priority=0.5)
    assert inc == 20 * 16
    assert r.copies[1].prealloc_tokens == 32


def test_swap_out_floor_pins_shared_prefix():
    """Prefix-cache pinning (DESIGN.md §10.3): ``floor_tokens`` marks
    [0, floor) GPU-pinned — the copy is valid from 0 without any
    transfer, the increment covers only the private suffix, and the
    floor survives contamination of the phantom blocks below it."""
    r = KVCacheReuseManager(64, 16, enabled=True, prealloc_blocks=0)
    r.update_priority(1, 0.5)
    inc, _ = r.record_swap_out(1, 160, requesting_priority=0.5,
                               floor_tokens=48)
    assert inc == 160 - 48                  # only the private suffix moves
    assert r.valid_tokens(1) == 160
    # re-swap at the same context: nothing to transfer
    inc, _ = r.record_swap_out(1, 160, requesting_priority=0.5,
                               floor_tokens=48)
    assert inc == 0
    # a contamination can reclaim every CPU block — the floor keeps the
    # pinned prefix valid (its blocks are phantoms, never read)
    r.update_priority(2, 0.9)
    r.record_swap_out(2, 64 * 16, requesting_priority=0.9)
    assert r.valid_tokens(1) <= 160
    inc, _ = r.record_swap_out(1, 48, requesting_priority=0.5,
                               floor_tokens=48)
    assert inc == 0
    assert r.valid_tokens(1) >= 48


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 4), st.integers(1, 900),
                          st.floats(0, 1)),
                min_size=1, max_size=30))
def test_contamination_property_valid_prefix_capacity(ops):
    """Property: under ANY interleaving of swap-outs
    the uncontaminated prefix is backed by physical capacity beyond the
    preallocation — ``valid <= stored <= capacity`` and
    ``valid + prealloc <= capacity`` for every live copy (a contaminated
    victim can never claim tokens its remaining blocks don't hold)."""
    r = KVCacheReuseManager(128, 16, enabled=True, prealloc_blocks=2)
    for rid, tokens, prio in ops:
        r.update_priority(rid, prio)
        r.record_swap_out(rid, tokens, requesting_priority=prio)
        for other, copy in r.copies.items():
            cap = r.mgr.request_tokens(other)
            assert copy.valid_tokens <= copy.stored_tokens <= cap
            assert copy.valid_tokens + copy.prealloc_tokens <= cap
        r.mgr.check_invariants()


# ---------------------------------------------------------------------------
# both packages, the same swap-out sequences
# ---------------------------------------------------------------------------


def _copies(r):
    return ({k: (c.valid_tokens, c.stored_tokens, c.prealloc_tokens)
             for k, c in r.copies.items()},
            {k: r.mgr.request_block_ids(k) for k in r.copies},
            dict(r.mgr.free), r.n_contaminations)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 4), st.integers(1, 900),
                          st.floats(0, 1), st.integers(0, 9)),
                min_size=1, max_size=30),
       st.booleans())
def test_same_swap_outs_same_copies_as_reference(ops, enabled):
    """Swap-outs (some with a pinned floor), swap-ins, invalidations and
    releases through both managers: after each operation the copies, their
    CPU blocks, the free list and the contamination count are equal."""
    ours = KVCacheReuseManager(128, 16, enabled=enabled, prealloc_blocks=2)
    ref = jax_reuse.KVCacheReuseManager(128, 16, enabled=enabled,
                                        prealloc_blocks=2)
    for rid, tokens, prio, what in ops:
        for r in (ours, ref):
            r.update_priority(rid, prio)
            if what == 0:
                r.invalidate(rid)
            elif what == 1:
                r.release(rid)
            elif what == 2:
                assert r.record_swap_in(rid) == r.valid_tokens(rid)
            else:
                floor = 48 if what == 3 else 0
                got = r.record_swap_out(rid, tokens, requesting_priority=prio,
                                        floor_tokens=floor)
                if r is ours:
                    want = got
                else:
                    assert want == got
        assert _copies(ours) == _copies(ref)


# ---------------------------------------------------------------------------
# contaminated copies at swap-in: the reference's fault, the port's repair
# ---------------------------------------------------------------------------


def _engine_workload(engine_cls, cfg_cls, trace_cls, conv_cls, turn_cls,
                     mode, bundle=None, cpu_blocks=256):
    """chip_smoke.py's engine workload (8 two-turn conversations, prompts
    256-352 then 96-160 tokens, 32 generated a turn; 160 GPU blocks, a
    random priority storm, seed 13) with ``cpu_blocks`` CPU blocks
    instead of 1024, on one package.  Returns the engine, its
    conversations and what ``chip_smoke.watch_swap_ins`` saw."""
    convs = [conv_cls(conv_id=i, arrival_s=0.0,
                      turns=[turn_cls((256, 288, 320, 352)[i % 4], 32),
                             turn_cls((96, 128, 160)[i % 3], 32)],
                      think_time_s=0.05) for i in range(8)]
    cfg = cfg_cls(mode=mode, num_gpu_blocks=160, num_cpu_blocks=cpu_blocks,
                  max_running=8, max_batch=8, block_size=16,
                  seed=0).with_policy("fastswitch")
    eng = engine_cls(cfg, convs, trace=trace_cls("random", 0.5, seed=13),
                     model_bundle=bundle)
    seen = chip_smoke.watch_swap_ins(eng.core)
    eng.run(max_iterations=100_000)
    assert eng.done()
    return eng, convs, seen


def _packages():
    from repro.core import EngineConfig as JaxEngineConfig
    from repro.core import FastSwitchEngine as JaxFastSwitchEngine
    from repro.data.priority import PriorityTrace as JaxPriorityTrace
    from repro.data.sharegpt import Conversation as JaxConversation
    from repro.data.sharegpt import Turn as JaxTurn
    from repro_torch.core import EngineConfig, FastSwitchEngine
    from repro_torch.data.priority import PriorityTrace
    from repro_torch.data.sharegpt import Conversation, Turn
    return ((JaxFastSwitchEngine, JaxEngineConfig, JaxPriorityTrace,
             JaxConversation, JaxTurn),
            (FastSwitchEngine, EngineConfig, PriorityTrace, Conversation,
             Turn))


def _reference_restores_past_valid(cpu_blocks):
    """The reference's sim run of the workload: it swaps requests back in
    over copies shorter than their context and restores blocks past the
    valid prefix (its fault, documented).  Returns its engine."""
    ref, _, seen = _engine_workload(*_packages()[0], "sim",
                                    cpu_blocks=cpu_blocks)
    assert chip_smoke.past_valid_prefix(seen["restores"]), \
        "the reference no longer restores past a copy's valid prefix"
    ref.swap.shutdown()
    return ref


@pytest.mark.parametrize("cpu_blocks", [256, 192])
def test_contaminated_swap_in_sim_resumes_the_short_copy(cpu_blocks):
    """Sim mode, both packages: the reference restores blocks past a
    copy's valid prefix; the port meets the same short copies, restores
    nothing past their valid prefix and resumes each of them."""
    _reference_restores_past_valid(cpu_blocks)
    sim, _, seen = _engine_workload(*_packages()[1], "sim",
                                    cpu_blocks=cpu_blocks)
    short = chip_smoke.short_swap_ins(seen["swap_ins"])
    print(f"{cpu_blocks} CPU blocks: contaminations "
          f"{sim.reuse.n_contaminations}, swap-ins {len(seen['swap_ins'])}, "
          f"short copies (request, context, valid) {short}, "
          f"{sim.reuse.stats()}")
    assert chip_smoke.past_valid_prefix(seen["restores"]) == []
    assert short and sim.reuse.n_short_copy_resumes >= 1
    assert sim.reuse.n_short_copy_resumes <= len(short)
    sim.swap.shutdown()


@pytest.mark.parametrize("cpu_blocks", [384, 1024])
def test_sim_equal_to_the_reference_without_short_copies(cpu_blocks):
    """Where no swap-in meets a short copy the port's sim run is the
    reference's: summary, TTFT / TBT lists, swap stats, event log."""
    ref, _, ref_seen = _engine_workload(*_packages()[0], "sim",
                                        cpu_blocks=cpu_blocks)
    sim, _, seen = _engine_workload(*_packages()[1], "sim",
                                    cpu_blocks=cpu_blocks)
    assert chip_smoke.short_swap_ins(ref_seen["swap_ins"]) == []
    assert seen == ref_seen
    assert_sim_equal(sim, ref)
    assert sim.reuse.n_short_copy_resumes == 0
    sim.swap.shutdown()
    ref.swap.shutdown()


def test_contaminated_swap_in_serves_dense_argmax_tokens():
    """The fault at the size ``ROADMAP.md`` queue 3 named, 256 CPU
    blocks.  The reference's sim run still swaps requests back in past
    their copy's valid prefix (request 4 first, 426 tokens over 281
    valid).  The port's sim and real runs (the reduced model with the
    reference's weights) restore no block past a valid prefix, resume at
    least one short copy, and the real run serves every generated token
    as the dense forward's argmax or within 0.05 of it.  The reference's
    real-mode run of this workload is too slow for the suite on the CPU,
    so the reference runs here in sim mode only."""
    import jax
    import numpy as np
    import torch

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import transformer as jax_T
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T

    ref = _reference_restores_past_valid(256)
    sim, _, sim_seen = _engine_workload(*_packages()[1], "sim")
    assert chip_smoke.past_valid_prefix(sim_seen["restores"]) == []
    assert sim.reuse.n_short_copy_resumes >= 1
    sim.swap.shutdown()
    cfg = get_smoke_config("qwen2-1.5b")
    params = T.params_from_numpy(
        jax.tree.map(np.asarray,
                     jax_T.init_params(jax_smoke_config("qwen2-1.5b"),
                                       jax.random.PRNGKey(0))),
        device="cpu")
    with chip_smoke.swaps_follow_the_clock():
        eng, convs, seen = _engine_workload(
            *_packages()[1], "real", {"cfg": cfg, "params": params})
    first_wrong = {}
    with torch.no_grad():
        for c in convs:
            hist = eng._token_hist_by_conv[c.conv_id]
            logits, _, _ = T.forward_seq(params, cfg, torch.tensor([hist]))
            pos = 0
            for t in c.turns:
                pos += t.prompt_tokens
                for i in range(pos, pos + t.response_tokens):
                    lg = logits[0, i - 1]
                    if float(lg.max() - lg[hist[i]]) >= chip_smoke.NEAR_TIE:
                        first_wrong.setdefault(c.conv_id, i)
                pos += t.response_tokens
    eng.swap.shutdown()
    print("contaminations, reference sim:", ref.reuse.n_contaminations,
          "port sim:", sim.reuse.n_contaminations,
          "real:", eng.reuse.n_contaminations)
    print("short copies met (request, context, valid), real:",
          chip_smoke.short_swap_ins(seen["swap_ins"]),
          "resumed:", eng.reuse.stats())
    print("first wrong (conversation, position):",
          sorted(first_wrong.items()))
    assert chip_smoke.past_valid_prefix(seen["restores"]) == []
    assert eng.reuse.n_short_copy_resumes >= 1
    assert not first_wrong, \
        f"tokens below the dense maximum from {sorted(first_wrong.items())}"
