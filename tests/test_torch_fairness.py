"""The paper's scenarios and four-policy ladder in the port
(``repro_torch.launch.scenarios``, ``examples/torch_fairness_comparison.py``)
against the reference's engine driven with the same parameters.

  * ``SCENARIOS`` and ``POLICY_ORDER`` equal the reference's
    (``benchmarks/common.py:13-34``, written out below: this suite does not
    import ``benchmarks``);
  * ``run_policy`` for both scenarios and all four policies at 16
    conversations (``workload_overrides``) against the reference's
    ``FastSwitchEngine`` in sim mode on the same conversations, trace and
    configuration: the summary less ``callstack_wall_s``, the TTFT and TBT
    lists and ``swap.stats()`` equal exactly;
  * the example, run as a subprocess with ``jax`` blocked, prints the
    lines the reference example's formatting gives from the reference's
    engine at the full scenario size.
"""
import dataclasses
import os
import subprocess
import sys

import pytest

from repro.core import EngineConfig as JaxEngineConfig
from repro.core import FastSwitchEngine as JaxFastSwitchEngine
from repro.data.priority import PriorityTrace as JaxPriorityTrace
from repro.data.sharegpt import sample_conversations as jax_conversations
from repro.io.cost_model import A10_PCIE4 as JAX_A10
from repro.io.cost_model import A100_PCIE4 as JAX_A100
from repro_torch.launch import scenarios
from torch_parity import assert_sim_equal
from torch_threads import one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "torch_fairness_comparison.py")

# benchmarks/common.py:16-34, the reference's scenarios
REFERENCE_SCENARIOS = {
    "llama8b-a10": dict(
        engine=dict(hardware=JAX_A10, num_gpu_blocks=1024,
                    num_cpu_blocks=8192, max_running=32,
                    model_params=8_000_000_000, kv_bytes_per_token=131072),
        workload=dict(rate_req_s=0.4, n_convs=100, max_context=4000),
        update_freq=0.04),
    "qwen32b-a100": dict(
        engine=dict(hardware=JAX_A100, num_gpu_blocks=1536,
                    num_cpu_blocks=12288, max_running=32,
                    model_params=32_000_000_000,
                    kv_bytes_per_token=262144),
        workload=dict(rate_req_s=0.4, n_convs=100, max_context=6000),
        update_freq=0.02),
}
REFERENCE_POLICY_ORDER = ["vllm", "+dbg", "+dbg+reuse", "fastswitch"]
N_CONVS = 16


def reference_engine(scenario: str, policy: str, n_convs=None,
                     pattern: str = "markov", seed: int = 7):
    """The reference's ``run_policy`` (``benchmarks/common.py:37-57``),
    written out on ``repro.core``."""
    sc = REFERENCE_SCENARIOS[scenario]
    wl = dict(sc["workload"])
    if n_convs is not None:
        wl["n_convs"] = n_convs
    convs = jax_conversations(wl["n_convs"], rate_req_s=wl["rate_req_s"],
                              seed=seed, max_context=wl["max_context"])
    cfg = JaxEngineConfig(mode="sim", **sc["engine"]).with_policy(policy)
    eng = JaxFastSwitchEngine(
        cfg, convs, trace=JaxPriorityTrace(pattern, sc["update_freq"],
                                           seed=seed))
    eng.run(max_iterations=2_000_000)
    assert eng.done()
    return eng


def reference_lines(engines) -> list:
    """``examples/fairness_comparison.py``'s header and policy lines from
    the reference's engines, by its own format strings."""
    lines = [f"{'policy':14s} {'p95 TTFT':>12s} {'p99 TTFT':>12s} "
             f"{'p99.9 TBT':>12s} {'tok/s':>8s} {'swap ops':>9s} "
             f"{'stall':>9s}"]
    for pol, eng in engines:
        s = eng.metrics.summary()
        sw = eng.swap.stats()
        lines.append(
            f"{pol:14s} {s['p95_ttft_ms']:10.0f} ms "
            f"{s['p99_ttft_ms']:10.0f} ms "
            f"{s['p999_tbt_ms']:10.0f} ms {s['throughput_tok_s']:8.1f} "
            f"{sw['total_ops']:9d} {sw['total_stall_us'] / 1e6:7.1f}s")
    return lines


def test_scenarios_and_ladder_equal_the_reference():
    assert scenarios.POLICY_ORDER == REFERENCE_POLICY_ORDER
    assert set(scenarios.SCENARIOS) == set(REFERENCE_SCENARIOS)
    for name, want in REFERENCE_SCENARIOS.items():
        got = scenarios.SCENARIOS[name]
        assert got["workload"] == want["workload"]
        assert got["update_freq"] == want["update_freq"]
        g, w = dict(got["engine"]), dict(want["engine"])
        assert dataclasses.asdict(g.pop("hardware")) \
            == dataclasses.asdict(w.pop("hardware"))
        assert g == w


@pytest.mark.parametrize("policy", REFERENCE_POLICY_ORDER)
@pytest.mark.parametrize("scenario", sorted(REFERENCE_SCENARIOS))
def test_run_policy_equals_the_reference(scenario, policy):
    ours = scenarios.run_policy(scenario, policy,
                                workload_overrides={"n_convs": N_CONVS})
    ref = reference_engine(scenario, policy, n_convs=N_CONVS)
    assert ours.metrics.total_tokens > 0 and ours.metrics.preemptions > 0
    assert_sim_equal(ours, ref)


def test_example_prints_the_reference_ladder():
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            f"runpy.run_path({EXAMPLE!r}, run_name='__main__')\n"
            "assert not any(m == 'repro' or m.startswith('repro.')\n"
            "               or m == 'benchmarks' for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        want = reference_lines(
            [(pol, reference_engine("llama8b-a10", pol))
             for pol in REFERENCE_POLICY_ORDER])
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    lines = out.splitlines()
    assert lines[:len(want)] == want
    assert len(lines) == len(want) + 2 and lines[-2] == ""
