"""A sim-mode request preempted mid chunked prefill
(``ServingEngine._preempt`` -> ``_abort_chunked_prefill``).

Sim mode used to swap such a request out whole: it sat SWAPPED (or
WAITING) with ``prefill_remaining > 0``, which the sanitizer's P1 forbids,
and chip_smoke's engine workload at a chunk of 64 tripped it at iteration
6 in both packages.  The port now takes real mode's route: the processed
prefix is kept as a reuse copy and the request goes back to WAITING for a
fresh admission (a resume caught mid recomputation back to SWAPPED), with
``context_tokens`` counting the processed prefix as real mode counts it.

  * the storm: the engine workload (8 two-turn conversations, 160 GPU /
    1024 CPU blocks, the priority storm of seed 13) at a chunk of 64, the
    sanitizer after every step, in swap and recompute mode, and over more
    storm seeds: every turn finished, mid-prefill aborts met;
  * the reference's engine on the same storm still trips P1 (the fault
    the storm is for);
  * a sim run whose chunk covers every prompt, or no chunk, is the
    reference's op for op (summary, TTFT / TBT, swap stats, event log);
  * real mode at smoke size on the same storm, chunk 64, sanitizer on.
"""
import dataclasses
import os
import sys

import pytest

from repro.core import EngineConfig as JaxEngineConfig
from repro.core import FastSwitchEngine as JaxFastSwitchEngine
from repro.core import InvariantViolation as JaxInvariantViolation
from repro.data import priority as jax_priority
from repro.data import sharegpt as jax_sharegpt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
from repro_torch.core import EngineConfig, FastSwitchEngine  # noqa: E402
from repro_torch.data.priority import PriorityTrace  # noqa: E402
from torch_parity import assert_sim_equal, smoke_bundles  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

CHUNK = 64
STORM_SEED = 13


def _convs(sharegpt=None):
    """chip_smoke's engine workload, as ``sharegpt``'s conversations (the
    port's by default)."""
    convs = chip_smoke.conversations(8, (256, 288, 320, 352),
                                     (96, 128, 160), max_tokens=32)
    if sharegpt is None:
        return convs
    return [sharegpt.Conversation(
        conv_id=c.conv_id, arrival_s=c.arrival_s,
        turns=[sharegpt.Turn(t.prompt_tokens, t.response_tokens)
               for t in c.turns], think_time_s=c.think_time_s)
        for c in convs]


def _config(cls, mode="sim", chunk=CHUNK, preemption="swap",
            policy="fastswitch"):
    cfg = cls(mode=mode, num_gpu_blocks=160, num_cpu_blocks=1024,
              max_running=8, max_batch=8, block_size=16, seed=0,
              check_invariants_every=1).with_policy(policy)
    return dataclasses.replace(cfg, policy=dataclasses.replace(
        cfg.policy, chunked_prefill_tokens=chunk,
        preemption_mode=preemption))


def _logged(eng):
    """``eng`` (either package's replay engine) keeping its core's event
    log, which the replay client turns off."""
    eng.core.events = []
    return eng


def _mid_prefill_aborts(eng) -> int:
    return sum(1 for e in eng.events
               if e.kind == "preempt" and e.data.get("mid_prefill"))


@pytest.mark.parametrize("seed", [STORM_SEED, 3, 29])
@pytest.mark.parametrize("preemption", ["swap", "recompute"])
def test_sim_storm_at_a_short_chunk_keeps_p1(preemption, seed):
    convs = _convs()
    eng = _logged(FastSwitchEngine(
        _config(EngineConfig, preemption=preemption), convs,
        trace=PriorityTrace("random", 0.5, seed=seed)))
    eng.run(max_iterations=100_000)
    assert eng.done()
    m = eng.metrics
    assert m.total_tokens == sum(t.response_tokens for c in convs
                                 for t in c.turns)
    assert m.invariant_checks == m.iterations
    assert _mid_prefill_aborts(eng) > 0, "the storm met no mid-prefill " \
        "preemption"
    eng.gpu_mgr.check_invariants()
    eng.reuse.mgr.check_invariants()


def test_reference_sim_storm_trips_p1():
    """The fault the storm is for, in the reference (which is not
    edited): its sim engine leaves a preempted request with a prefill
    pending."""
    eng = JaxFastSwitchEngine(
        _config(JaxEngineConfig), _convs(jax_sharegpt),
        trace=jax_priority.PriorityTrace("random", 0.5, seed=STORM_SEED))
    with pytest.raises(JaxInvariantViolation, match="P1"):
        eng.run(max_iterations=100_000)


@pytest.mark.parametrize("policy,chunk", [
    ("fastswitch", 0), ("vllm", 0), ("vllm-recompute", 0),
    ("fastswitch+chunked", 512)])
def test_sim_without_a_short_chunk_equals_the_reference(policy, chunk):
    """No chunk, or one that covers every prefill (512 tokens; at most
    352 + 32 + 160 = 544 with nothing reused, which the reuse copies of
    ``fastswitch+chunked`` cut below it), never leaves a prefill
    pending: the run is the reference's op for op."""
    kw = dict(chunk=chunk, policy=policy,
              preemption=("recompute" if policy == "vllm-recompute"
                          else "swap"))
    ref = _logged(JaxFastSwitchEngine(
        _config(JaxEngineConfig, **kw), _convs(jax_sharegpt),
        trace=jax_priority.PriorityTrace("random", 0.5, seed=STORM_SEED)))
    ref.run(max_iterations=100_000)
    ours = _logged(FastSwitchEngine(
        _config(EngineConfig, **kw), _convs(),
        trace=PriorityTrace("random", 0.5, seed=STORM_SEED)))
    ours.run(max_iterations=100_000)
    assert ref.done() and ours.done()
    assert _mid_prefill_aborts(ours) == 0
    assert_sim_equal(ours, ref)


@pytest.mark.parametrize("preemption", ["swap", "recompute"])
def test_real_storm_at_a_short_chunk_keeps_the_sanitizer(preemption):
    """Real mode already aborted such a request; the same storm at smoke
    size (the reduced qwen2-1.5b) runs clean under the sanitizer."""
    convs = chip_smoke.conversations(4, (96, 128), (48, 64), max_tokens=8)
    cfg = dataclasses.replace(
        _config(EngineConfig, mode="real", preemption=preemption),
        num_gpu_blocks=40, max_running=4, max_batch=4)
    eng = FastSwitchEngine(cfg, convs, trace=PriorityTrace(
        "random", 0.5, seed=STORM_SEED), model_bundle=smoke_bundles()[1])
    eng.run(max_iterations=20_000)
    assert eng.done()
    assert eng.metrics.invariant_checks == eng.metrics.iterations
    assert eng.runner.stats.prefill_chunks > eng.runner.stats.prefills
    eng.shutdown()
