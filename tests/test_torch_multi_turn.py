"""Real-mode multi-turn conversations end to end in the port: the cases
of ``tests/test_multi_turn.py``, and the clean run through both packages.

Three-turn conversations through the real engine under storm preemption:
emitted tokens must be bit-exact with the reuse manager ON vs OFF (the
KV Cache Reuse Mechanism is a pure transfer optimization — it must never
change tokens), and on a clean run the d2h transfer accounting must
prove the reuse path swaps out ONLY the increment on later turns while
the disabled baseline re-writes whole contexts.
"""
import os
import sys
from dataclasses import replace

import pytest

from repro.core import EngineConfig as JaxEngineConfig
from repro.core import FastSwitchEngine as JaxFastSwitchEngine
from repro.core.policies import POLICIES as JAX_POLICIES
from repro.data import priority as jax_priority
from repro.data import sharegpt as jax_sharegpt
from repro_torch.core import EngineConfig, FastSwitchEngine
from repro_torch.core.policies import POLICIES
from repro_torch.data.priority import PriorityTrace
from repro_torch.data.sharegpt import Conversation, Turn
from test_torch_serve import swaps_follow_the_clock  # noqa: F401
from torch_parity import assert_histories_agree, smoke_bundles
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

BS = 16
TURNS = [Turn(12, 6), Turn(10, 5), Turn(8, 4)]


@pytest.fixture(scope="module")
def model():
    """The reduced qwen2-1.5b with the reference fixture's weights."""
    return smoke_bundles()[1]


def _replay_prerefactor(model, conv, cid):
    """Straight-line replay of one conversation through the exact-shape
    data plane (``prefill_kv`` of the history, ``PagedPools.write_tokens``,
    then one ``paged_decode_step`` per token; ``chip_smoke.
    exact_shape_history``): the schedule-independent greedy reference,
    the port's counterpart of ``test_decode_consistency.
    _replay_prerefactor``."""
    assert conv.conv_id == cid
    return chip_smoke.exact_shape_history(model, conv, None,
                                          block_size=BS)["history"]


def _mk_convs(n=3):
    return [Conversation(conv_id=i, arrival_s=0.0, turns=list(TURNS),
                         think_time_s=0.2) for i in range(n)]


def _run(model, *, use_reuse, storm, gpu_blocks=64):
    pol = replace(POLICIES["fastswitch"], initial_group_blocks=4)
    if not use_reuse:
        pol = replace(pol, name="fastswitch-noreuse", use_reuse=False,
                      prealloc_blocks=0)
    trace = PriorityTrace("random", 0.5, seed=13) if storm \
        else PriorityTrace()
    cfg = EngineConfig(mode="real", num_gpu_blocks=gpu_blocks,
                       num_cpu_blocks=256, max_running=4, max_batch=4,
                       block_size=BS, swap_chunk_blocks=1, policy=pol)
    eng = FastSwitchEngine(cfg, _mk_convs(), trace=trace,
                           model_bundle=model)
    eng.run(max_iterations=30_000)
    assert eng.done()
    return eng


@pytest.mark.slow
def test_multi_turn_storm_reuse_on_vs_off_bitexact(model):
    """>=3 turns per request under storm preemption: the reuse manager
    must be invisible in the emitted tokens (bit-exact on vs off), and
    both must match the schedule-independent pre-refactor replay."""
    e_on = _run(model, use_reuse=True, storm=True, gpu_blocks=10)
    e_off = _run(model, use_reuse=False, storm=True, gpu_blocks=10)
    assert e_on.metrics.preemptions > 0, "schedule never preempted"
    assert e_off.metrics.preemptions > 0
    assert e_on._token_hist_by_conv == e_off._token_hist_by_conv, \
        "reuse manager changed emitted tokens"
    for cid, conv in enumerate(_mk_convs()):
        assert len(e_on._token_hist_by_conv[cid]) == \
            sum(t.prompt_tokens + t.response_tokens for t in TURNS)
        assert e_on._token_hist_by_conv[cid] == \
            _replay_prerefactor(model, conv, cid), \
            f"conv {cid} diverged from the pre-refactor replay"


def _expected_turn_blocks(incremental: bool):
    """d2h blocks a clean (preemption-free) run moves per conversation:
    one swap-out per turn boundary over ``context - 1`` tokens (the last
    slot's KV is produced by the next decode step).  The reuse path
    transfers only [valid_before, total) — re-touching at most the
    boundary partial block; the disabled baseline re-writes the whole
    context every turn."""
    total_blocks = 0
    ctx = 0
    valid = 0
    for t in TURNS:
        ctx += t.prompt_tokens + t.response_tokens
        total = ctx - 1
        b0 = (valid // BS) if incremental else 0
        total_blocks += -(-total // BS) - b0
        valid = total
    return total_blocks


def test_multi_turn_clean_run_swaps_increment_only(model):
    """Acceptance: on later turns the reuse path's d2h
    traffic is exactly the per-turn increment (plus the re-touched
    boundary block), while the disabled baseline re-writes every turn's
    whole context — proven from the swap manager's d2h block counter."""
    e_on = _run(model, use_reuse=True, storm=False)
    e_off = _run(model, use_reuse=False, storm=False)
    # the preemption counter includes turn-boundary retains (_finish_turn
    # swaps the KV copy out); a clean run has EXACTLY those and no more
    n_turn_ends = len(_mk_convs()) * len(TURNS)
    assert e_on.metrics.preemptions == n_turn_ends, "mid-turn preemption"
    assert e_off.metrics.preemptions == n_turn_ends
    assert e_on._token_hist_by_conv == e_off._token_hist_by_conv
    n = len(_mk_convs())
    assert e_on.swap.blocks_by_dir["out"] == n * _expected_turn_blocks(True)
    assert e_off.swap.blocks_by_dir["out"] == n * _expected_turn_blocks(False)
    assert e_on.swap.blocks_by_dir["out"] < e_off.swap.blocks_by_dir["out"]


def test_multi_turn_clean_run_matches_reference(model, swaps_follow_the_clock):
    """The clean run with reuse on through both packages: the same
    modelled metrics and d2h block count, and every three-turn history
    equal or first different at a near-tie."""
    jb, _ = smoke_bundles()
    ours = _run(model, use_reuse=True, storm=False)
    pol = replace(JAX_POLICIES["fastswitch"], initial_group_blocks=4)
    cfg = JaxEngineConfig(mode="real", num_gpu_blocks=64,
                          num_cpu_blocks=256, max_running=4, max_batch=4,
                          block_size=BS, swap_chunk_blocks=1, policy=pol)
    convs = [jax_sharegpt.Conversation(
        conv_id=i, arrival_s=0.0,
        turns=[jax_sharegpt.Turn(t.prompt_tokens, t.response_tokens)
               for t in TURNS], think_time_s=0.2) for i in range(3)]
    ref = JaxFastSwitchEngine(cfg, convs, trace=jax_priority.PriorityTrace(),
                              model_bundle=jb)
    ref.run(max_iterations=30_000)
    assert ref.done()
    got, want = ours.metrics.summary(), ref.metrics.summary()
    got.pop("callstack_wall_s")
    want.pop("callstack_wall_s")
    assert got == want
    assert ours.swap.blocks_by_dir == ref.swap.blocks_by_dir
    assert_histories_agree(model, ours._token_hist_by_conv,
                           ref._token_hist_by_conv)
