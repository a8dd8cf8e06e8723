"""Related-work baselines in the port: recompute preemption and Llumnix
buffering, the cases of ``tests/test_baseline_policies.py``, and each
policy's sim run against the reference's."""
import pytest

from repro_torch.core import EngineConfig, FastSwitchEngine
from repro_torch.data.priority import PriorityTrace
from repro_torch.data.sharegpt import sample_conversations
from torch_threads import one_torch_thread  # noqa: F401

from repro.core import EngineConfig as JaxEngineConfig
from repro.core import FastSwitchEngine as JaxFastSwitchEngine
from repro.data import priority as jax_priority
from repro.data import sharegpt as jax_sharegpt

CONVS = sample_conversations(30, rate_req_s=2.0, seed=13, max_context=3000)
TOTAL = sum(t.response_tokens for c in CONVS for t in c.turns)


def _run(policy):
    cfg = EngineConfig(mode="sim", num_gpu_blocks=384, num_cpu_blocks=4096,
                       max_running=8).with_policy(policy)
    eng = FastSwitchEngine(cfg, list(CONVS),
                           trace=PriorityTrace("random", 0.05, seed=3))
    m = eng.run(max_iterations=400_000)
    assert eng.done(), policy
    assert m.total_tokens == TOTAL
    return eng


def test_recompute_moves_no_bytes():
    eng = _run("vllm-recompute")
    assert eng.swap.total_ops == 0
    assert eng.swap.total_bytes == 0
    assert eng.metrics.preemptions > 0        # it did preempt — via compute


def test_recompute_pays_with_time():
    e_r = _run("vllm-recompute")
    e_s = _run("vllm")
    # recomputation burns more prefill work than swapping (paper §2.1)
    assert e_r.metrics.prefills > e_s.metrics.prefills
    assert (e_r.metrics.summary()["throughput_tok_s"]
            < e_s.metrics.summary()["throughput_tok_s"])


def test_llumnix_bounded_granularity():
    e_l = _run("llumnix")
    e_v = _run("vllm")
    e_f = _run("fastswitch")
    gran_l = e_l.swap.total_blocks / max(e_l.swap.total_ops, 1)
    gran_f = e_f.swap.total_blocks / max(e_f.swap.total_ops, 1)
    assert 1.0 < gran_l <= 2.0          # the 2-block buffer ceiling
    assert gran_f > gran_l               # block groups beat the buffer
    assert e_l.swap.total_ops < e_v.swap.total_ops
    assert e_f.swap.total_stall_us < e_l.swap.total_stall_us


def test_zip_halves_wire_bytes():
    """Wire compression halves bytes PER BLOCK (trajectories differ across
    policies, so compare the per-block ratio, not totals)."""
    e_f = _run("fastswitch")
    e_z = _run("fastswitch+zip")
    per_block_f = e_f.swap.total_bytes / max(e_f.swap.total_blocks, 1)
    per_block_z = e_z.swap.total_bytes / max(e_z.swap.total_blocks, 1)
    assert abs(per_block_z * 2 - per_block_f) <= 0.01 * per_block_f


def test_chunked_prefill_improves_tbt_tail():
    """BEYOND-PAPER: Sarathi-style chunked prefill cuts the TBT tail under
    prompt-heavy load (long prompts no longer stall the decode batch)."""
    convs = sample_conversations(40, rate_req_s=0.5, seed=5, prompt_mu=6.5,
                                 prompt_sigma=0.6, resp_mu=3.5,
                                 max_context=3000)

    def run(policy):
        cfg = EngineConfig(mode="sim", num_gpu_blocks=1024,
                           num_cpu_blocks=8192,
                           max_running=16).with_policy(policy)
        eng = FastSwitchEngine(cfg, list(convs),
                               trace=PriorityTrace("markov", 0.04, seed=2))
        m = eng.run(max_iterations=400_000)
        assert eng.done()
        return m.summary()

    s_full = run("fastswitch")
    s_chunk = run("fastswitch+chunked")
    assert s_chunk["total_tokens"] == s_full["total_tokens"]
    assert s_chunk["p999_tbt_ms"] < s_full["p999_tbt_ms"]


@pytest.mark.parametrize("policy", ["vllm-recompute", "llumnix",
                                    "fastswitch+zip"])
def test_policy_run_matches_reference(policy):
    """Each baseline's sim run of ``CONVS`` through both packages: the
    same summary (less wall time), latencies and swap traffic."""
    ref_convs = jax_sharegpt.sample_conversations(30, rate_req_s=2.0,
                                                  seed=13, max_context=3000)
    cfg = JaxEngineConfig(mode="sim", num_gpu_blocks=384,
                          num_cpu_blocks=4096, max_running=8
                          ).with_policy(policy)
    ref = JaxFastSwitchEngine(cfg, ref_convs,
                              trace=jax_priority.PriorityTrace(
                                  "random", 0.05, seed=3))
    rm = ref.run(max_iterations=400_000)
    port = _run(policy)
    ps, rs = port.metrics.summary(), rm.summary()
    ps.pop("callstack_wall_s")
    rs.pop("callstack_wall_s")
    assert ps == rs
    assert port.metrics.ttfts_us == rm.ttfts_us
    assert port.metrics.tbts_us == rm.tbts_us
    assert port.swap.stats() == ref.swap.stats()
