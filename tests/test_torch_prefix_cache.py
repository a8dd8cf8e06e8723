"""The prefix cache's real-mode path in the port (CPU, the reduced
qwen2-1.5b model): the engine builds ``PrefixCache`` as the reference
does, a sharer's prefill starts from the carry seeded out of the pool's
shared blocks (``ops.seed_prefill_carry``), and the refcount sanitizer
(C1/C2) runs after every step.

  * N users sharing a system prompt perform exactly one full-prefix
    prefill (the runner's prefill-token accounting);
  * under storm preemption and swaps the cache-on token histories equal
    the cache-off ones;
  * block pressure evicts unmapped cached leaves before it preempts;
  * C1/C2 stay clean, and a corrupted refcount trips them.

The same workloads as the reference's ``tests/test_prefix_cache.py``;
its swaps are held to the simulated clock (``swaps_follow_the_clock``,
see ``tests/test_torch_serve.py``) so two runs compare exactly.
"""
import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.core import (EngineConfig, InvariantViolation,
                              SamplingParams, ServingEngine,
                              check_engine_invariants)
from repro_torch.data.priority import PriorityTrace
from repro_torch.models import transformer as T
from test_torch_serve import swaps_follow_the_clock  # noqa: F401
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("qwen2-1.5b")
    return {"cfg": cfg, "params": T.init_params(cfg, seed=0, device="cpu")}


def shared_prompts(vocab: int, n_req: int, prefix_len: int = 49):
    rng = np.random.RandomState(7)
    sys_prefix = rng.randint(1, vocab, prefix_len).tolist()
    return [sys_prefix + rng.randint(1, vocab, 5 + 3 * i).tolist()
            for i in range(n_req)]


def _engine(model, prefix_cache: bool, num_gpu_blocks: int = 64,
            max_running: int = 4, max_batch: int = 4) -> ServingEngine:
    cfg = EngineConfig(mode="real", num_gpu_blocks=num_gpu_blocks,
                       num_cpu_blocks=256, max_running=max_running,
                       max_batch=max_batch, prefix_cache=prefix_cache,
                       check_invariants_every=1).with_policy("fastswitch")
    return ServingEngine(cfg, trace=PriorityTrace(), model_bundle=model,
                         stream_tokens=True)


def run_shared(model, prompts, prefix_cache, num_gpu_blocks=64,
               max_tokens=8):
    """The leader's prefill completes (and donates) before the sharers
    arrive.  Returns (token histories by handle, engine)."""
    eng = _engine(model, prefix_cache, num_gpu_blocks,
                  max_running=len(prompts))
    hists = {}

    def drain(budget):
        n = 0
        while eng.has_work() and n < budget:
            for out in eng.step():
                if out.token_ids:
                    hists.setdefault(out.handle, []).extend(out.token_ids)
            n += 1

    eng.add_request(list(prompts[0]), SamplingParams(max_tokens=max_tokens),
                    handle=0)
    drain(2)
    for h, toks in enumerate(prompts[1:], start=1):
        eng.add_request(list(toks), SamplingParams(max_tokens=max_tokens),
                        handle=h)
    drain(5000)
    assert not eng.has_work()
    eng.shutdown()
    return hists, eng


def test_n_sharers_single_full_prefill(model, swaps_follow_the_clock):
    """The leader forwards its whole prompt; every sharer only its private
    suffix past the block-aligned shared prefix."""
    prompts = shared_prompts(model["cfg"].vocab_size, n_req=4)
    hists, eng = run_shared(model, prompts, prefix_cache=True)
    shared = (49 // 16) * 16
    assert eng.runner.stats.prefill_tokens == \
        len(prompts[0]) + sum(len(p) - shared for p in prompts[1:])
    assert eng.prefix.stats()["hits"] == len(prompts) - 1
    assert eng.metrics.prefix_tokens_saved == (len(prompts) - 1) * shared
    assert eng.metrics.invariant_checks > 0
    assert sorted(hists) == list(range(len(prompts)))
    # a sharer's tokens are those it makes alone, from a full prefill
    for h in (1, 3):
        alone, _ = run_shared(model, [prompts[h]], prefix_cache=False)
        assert hists[h] == alone[0]


def test_storm_tokens_equal_the_cache_disabled_run(model,
                                                   swaps_follow_the_clock):
    """A tight pool (22 blocks) preempts and swaps; the cache-on histories
    equal the cache-off ones with C1/C2 checked every step, and the cache
    saves prefill."""
    prompts = shared_prompts(model["cfg"].vocab_size, n_req=4)
    h_off, e_off = run_shared(model, prompts, False, num_gpu_blocks=22,
                              max_tokens=10)
    h_on, e_on = run_shared(model, prompts, True, num_gpu_blocks=22,
                            max_tokens=10)
    assert h_on == h_off
    assert all(len(h) == 10 for h in h_on.values())
    assert e_on.metrics.preemptions > 0 and e_on.metrics.swap_out_count > 0
    assert e_on.metrics.invariant_checks > 0
    assert e_on.runner.stats.prefill_tokens < e_off.runner.stats.prefill_tokens


def test_engine_evicts_cache_before_preempting(model, swaps_follow_the_clock):
    """After the sharers finish, a distinct 150-token prompt (10 blocks,
    more than the 9 left beside the 3-block pinned tree) reclaims cached
    leaves and completes."""
    vocab = model["cfg"].vocab_size
    prompts = shared_prompts(vocab, n_req=2)
    eng = _engine(model, True, num_gpu_blocks=12, max_running=2,
                  max_batch=2)
    for h in (0, 1):
        eng.add_request(list(prompts[h]), SamplingParams(max_tokens=4),
                        handle=h)
        while eng.has_work():
            eng.step()
    assert eng.prefix.stats()["hits"] == 1
    big = np.random.RandomState(99).randint(1, vocab, 150).tolist()
    eng.add_request(big, SamplingParams(max_tokens=4), handle=2)
    done = False
    while eng.has_work():
        for out in eng.step():
            done |= out.handle == 2 and out.finished
    assert done
    assert eng.metrics.prefix_evictions > 0
    assert eng.metrics.invariant_checks > 0
    eng.shutdown()


def test_refcount_sanitizer_stays_clean_and_trips_on_a_leak(
        model, swaps_follow_the_clock):
    """C1/C2 hold after every step of a shared run, with sharers still
    mapping the tree mid-run; a refcount the tree does not account for
    is caught."""
    prompts = shared_prompts(model["cfg"].vocab_size, n_req=3)
    eng = _engine(model, True)
    eng.add_request(list(prompts[0]), SamplingParams(max_tokens=6), handle=0)
    eng.step()
    eng.step()
    for h in (1, 2):
        eng.add_request(list(prompts[h]), SamplingParams(max_tokens=6),
                        handle=h)
    mapped = 0
    while eng.has_work():
        eng.step()
        check_engine_invariants(eng)
        mapped = max(mapped, eng.prefix.stats()["mapped_requests"])
    assert mapped >= 2 and eng.metrics.invariant_checks > 0
    node = next(iter(eng.prefix.iter_nodes()))
    eng.gpu_mgr.ref_block(node.block)
    with pytest.raises(InvariantViolation, match="C1"):
        check_engine_invariants(eng)
    eng.gpu_mgr.unref_block(node.block)
    check_engine_invariants(eng)
    eng.shutdown()


def test_prefix_cache_refused_where_the_reference_refuses_it(model):
    with pytest.raises(ValueError, match="mode='real'"):
        ServingEngine(EngineConfig(mode="sim", prefix_cache=True)
                      .with_policy("fastswitch"))
    with pytest.raises(ValueError, match="reuse-enabled"):
        ServingEngine(EngineConfig(mode="real", num_gpu_blocks=16,
                                   prefix_cache=True).with_policy("vllm"),
                      model_bundle=model)
