"""End-to-end system behaviour of the port: the full stack (priority
scheduler, block groups, swap manager, reuse, a real model and the paged
attention and run-copy kernels' plain versions on the CPU) serving
multi-turn conversations — the cases of ``tests/test_system.py``, with its
seeds and sizes, on the reduced qwen2-1.5b and, as the reference suite,
the reduced llama3.2-3b (the reference fixture's weights,
``init_params(cfg, PRNGKey(0))``).

  * real serving finishes every turn, every response token counted, one
    TTFT per turn, the block managers' invariants intact;
  * the policies agree on tokens: all four of the paper's ladder
    (``POLICY_ORDER``) give each conversation the same greedy tokens, or a
    stream first differs from the first policy's at a near-tie of the
    port's logits (``NEAR_TIE``, as ``tests/test_torch_engine.py``);
    and each port policy's streams agree so with the reference engine's
    runs of the same workload, trace and weights under the reference
    case's own pair, vllm and fastswitch (``assert_histories_agree``).
    The reference's own case, for vllm and fastswitch, asserts bit
    equality and fails under jax 0.9.0 (ROADMAP queue 3).
"""
import pytest

from repro.core import EngineConfig as JaxEngineConfig
from repro.core import FastSwitchEngine as JaxFastSwitchEngine
from repro.data.priority import PriorityTrace as JaxPriorityTrace
from repro.data.sharegpt import sample_conversations as jax_conversations
from repro_torch.core import EngineConfig, FastSwitchEngine
from repro_torch.data.priority import PriorityTrace
from repro_torch.data.sharegpt import sample_conversations
from repro_torch.launch.scenarios import POLICY_ORDER
from test_torch_engine import NEAR_TIE, first_divergence_gap
from torch_parity import assert_histories_agree, smoke_bundles
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["qwen2-1.5b", "llama3.2-3b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_end_to_end_real_serving(arch):
    bundle = smoke_bundles(arch)[1]
    convs = sample_conversations(6, rate_req_s=4.0, seed=5, prompt_mu=2.5,
                                 resp_mu=2.2, max_tokens=48)
    total_resp = sum(t.response_tokens for c in convs for t in c.turns)
    ec = EngineConfig(mode="real", num_gpu_blocks=96, num_cpu_blocks=512,
                      max_running=4, max_batch=4).with_policy("fastswitch")
    eng = FastSwitchEngine(ec, list(convs),
                           trace=PriorityTrace("markov", 0.05, seed=2),
                           model_bundle=bundle)
    m = eng.run(max_iterations=50_000)
    assert eng.done()
    s = m.summary()
    # system stayed consistent
    eng.gpu_mgr.check_invariants()
    eng.reuse.mgr.check_invariants()
    assert m.total_tokens == total_resp
    assert s["throughput_tok_s"] > 0
    assert len(m.ttfts_us) == sum(len(c.turns) for c in convs)
    eng.shutdown()


def _agree_run(pol, bundle, config=EngineConfig, engine=FastSwitchEngine,
               trace=PriorityTrace, conversations=sample_conversations):
    """The histories of one run of the reference case's workload under
    ``pol``, by the given package's engine."""
    convs = conversations(4, rate_req_s=4.0, seed=9, prompt_mu=2.5,
                          resp_mu=2.0, max_tokens=32)
    ec = config(mode="real", num_gpu_blocks=48, num_cpu_blocks=512,
                max_running=3, max_batch=4).with_policy(pol)
    eng = engine(ec, convs, trace=trace("random", 0.2, seed=4),
                 model_bundle=bundle)
    eng.run(max_iterations=50_000)
    assert eng.done()
    assert eng.metrics.preemptions > 0
    hists = {cid: list(h) for cid, h in eng._token_hist_by_conv.items()}
    eng.shutdown()
    return hists


@pytest.mark.parametrize("arch", ARCHS)
def test_end_to_end_policies_agree_on_tokens(arch):
    """Different policies change WHEN work happens, never WHAT is
    computed: each conversation's token stream is the same under every
    policy of the ladder, or parts from the first policy's at a near-tie;
    and every policy's agrees so with the reference engine's vllm and
    fastswitch runs."""
    jbundle, bundle = smoke_bundles(arch)
    hists = {pol: _agree_run(pol, bundle) for pol in POLICY_ORDER}
    ref = {pol: _agree_run(pol, jbundle, JaxEngineConfig,
                           JaxFastSwitchEngine, JaxPriorityTrace,
                           jax_conversations)
           for pol in ("vllm", "fastswitch")}
    held = 0
    for pol in POLICY_ORDER:
        for want in ref.values():
            held += assert_histories_agree(bundle, hists[pol], want)
    print(f"{arch}: {held} of {len(hists['vllm']) * 8} streams equal the "
          "reference engine's")
    first = hists[POLICY_ORDER[0]]
    equal = 0
    for pol in POLICY_ORDER[1:]:
        assert set(hists[pol]) == set(first)
        for cid, want in first.items():
            d = first_divergence_gap(bundle["params"], bundle["cfg"],
                                     list(hists[pol][cid]), list(want))
            assert d is None or d[1] < NEAR_TIE, \
                f"{pol}, conv {cid}: parts from {POLICY_ORDER[0]} at " \
                f"{d[0]} with gap {d[1]}"
            equal += d is None
    print(f"{arch}: {equal} of {len(first) * 3} streams equal the "
          f"{POLICY_ORDER[0]} policy's")
