"""The port's KV Cache Reuse Mechanism (``repro_torch.core.reuse``,
FastSwitch §3.3): the cases of ``tests/test_reuse.py``, the same
swap-out sequences through both packages' managers, and the open
contamination fault of ``ROADMAP.md`` queue 3 reproduced at its size.

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

from repro.core import reuse as jax_reuse  # noqa: E402
from repro_torch.core.reuse import KVCacheReuseManager  # noqa: E402
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
# the open contamination fault (ROADMAP.md queue 3), both packages
# ---------------------------------------------------------------------------


CONTAMINATION_SIZES = dict(gpu_blocks=160, cpu_blocks=256, max_running=8)


def _engine_workload(engine_cls, cfg_cls, trace_cls, conv_cls, turn_cls,
                     mode, bundle=None):
    """chip_smoke.py's engine workload (8 two-turn conversations, prompts
    256-352 then 96-160 tokens, 32 generated a turn; 160 GPU blocks, a
    random priority storm, seed 13) with 256 CPU blocks instead of 1024,
    on one package.  Returns the engine and, per swap-in, (request,
    context tokens, valid tokens of its CPU copy, CPU capacity in
    tokens) as the engine saw them."""
    convs = [conv_cls(conv_id=i, arrival_s=0.0,
                      turns=[turn_cls((256, 288, 320, 352)[i % 4], 32),
                             turn_cls((96, 128, 160)[i % 3], 32)],
                      think_time_s=0.05) for i in range(8)]
    cfg = cfg_cls(mode=mode,
                  num_gpu_blocks=CONTAMINATION_SIZES["gpu_blocks"],
                  num_cpu_blocks=CONTAMINATION_SIZES["cpu_blocks"],
                  max_running=8, max_batch=8, block_size=16,
                  seed=0).with_policy("fastswitch")
    eng = engine_cls(cfg, convs, trace=trace_cls("random", 0.5, seed=13),
                     model_bundle=bundle)
    swap_ins = []
    core = eng.core
    real = core._swap_in

    def swap_in(rid):
        req = core._req(rid)
        swap_ins.append((rid, req.context_tokens,
                         core.reuse.valid_tokens(rid),
                         core.reuse.mgr.request_tokens(rid)))
        return real(rid)
    core._swap_in = swap_in
    eng.run(max_iterations=100_000)
    assert eng.done()
    return eng, convs, swap_ins


@pytest.mark.xfail(strict=True, raises=AssertionError, reason=(
    "ROADMAP.md queue 3, KV reuse contamination: a SWAPPED request whose "
    "CPU copy is contaminated is swapped back in over its whole context, "
    "the copy trimmed to the prefix it still backs, so the positions past "
    "it keep stale KV; both packages"))
def test_contaminated_swap_in_serves_dense_argmax_tokens():
    """The fault at the size ``ROADMAP.md`` queue 3 names.  Both
    packages' sim runs of the workload make the same decisions, swap-ins
    past the valid prefix of their request's CPU copy included; the
    port's real-mode run on the reduced model with the reference's
    weights must then serve each generated token as the dense forward's
    argmax or within 0.05 of it.

    It does not.  Its run makes 15 contaminations, and five swap-ins
    restore a context past the valid prefix their copy kept: request 4
    first, 426 tokens over 281 valid (request 7 contaminated its copy
    while it was SWAPPED), then 1 (453 over 319), 7 (521 over 376) and 3
    (493 over 383, then 494 over 0).  The first wrong tokens are
    conversation 4 at position 426, 1 at 453, 3 at 494 and 7 at 531.  The
    reference's real-mode run of this workload is too slow for the suite
    on the CPU, so the reference runs here in sim mode only."""
    import jax
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core import EngineConfig as JaxEngineConfig
    from repro.core import FastSwitchEngine as JaxFastSwitchEngine
    from repro.data.priority import PriorityTrace as JaxPriorityTrace
    from repro.data.sharegpt import Conversation as JaxConversation
    from repro.data.sharegpt import Turn as JaxTurn
    from repro.models import transformer as jax_T
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import EngineConfig, FastSwitchEngine
    from repro_torch.data.priority import PriorityTrace
    from repro_torch.data.sharegpt import Conversation, Turn
    from repro_torch.models import transformer as T

    ref, _, ref_ins = _engine_workload(
        JaxFastSwitchEngine, JaxEngineConfig, JaxPriorityTrace,
        JaxConversation, JaxTurn, "sim")
    sim, _, sim_ins = _engine_workload(
        FastSwitchEngine, EngineConfig, PriorityTrace, Conversation, Turn,
        "sim")
    # the control plane at this size: the same contaminations and swap-ins
    # in both packages, some swap-ins past the valid prefix of their copy
    assert sim_ins == ref_ins
    assert sim.reuse.n_contaminations == ref.reuse.n_contaminations
    sim.swap.shutdown()
    ref.swap.shutdown()
    cfg = get_smoke_config("qwen2-1.5b")
    params = T.params_from_numpy(
        jax.tree.map(np.asarray,
                     jax_T.init_params(jax_smoke_config("qwen2-1.5b"),
                                       jax.random.PRNGKey(0))),
        device="cpu")
    with chip_smoke.swaps_follow_the_clock():
        eng, convs, ins = _engine_workload(
            FastSwitchEngine, EngineConfig, PriorityTrace, Conversation,
            Turn, "real", {"cfg": cfg, "params": params})
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
    print("contaminations, sim (both packages):", sim.reuse.n_contaminations,
          "real:", eng.reuse.n_contaminations)
    print("swap-ins past the valid prefix (request, context, valid, CPU "
          "capacity), sim:", [x for x in sim_ins if x[2] < x[1] - 1],
          "real:", [x for x in ins if x[2] < x[1] - 1])
    print("first wrong (conversation, position):",
          sorted(first_wrong.items()))
    assert not first_wrong, \
        f"tokens below the dense maximum from {sorted(first_wrong.items())}"
