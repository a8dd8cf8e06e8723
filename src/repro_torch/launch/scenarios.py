"""The paper's serving scenarios and its four-policy ladder, in sim mode.

The port's copy of ``SCENARIOS``, ``POLICY_ORDER`` and ``run_policy`` of
the reference's ``benchmarks/common.py:13-57``: the same parameters and
seeds, the same engine (``EngineConfig(mode="sim", ...)`` through the
replay client), the same drain check.  ``examples/
torch_fairness_comparison.py`` prints the ladder from it.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core import EngineConfig, FastSwitchEngine
from repro_torch.data.priority import PriorityTrace
from repro_torch.data.sharegpt import sample_conversations
from repro_torch.io.cost_model import A10_PCIE4, A100_PCIE4

# Paper §4: LLaMA-8B on A10 24 GB and Qwen-32B on A100 80 GB, each with
# 60 GB CPU swap space, ShareGPT multi-turn, Poisson 1 req/s.  The block
# budgets are scaled to CPU-tractable trace sizes while keeping the same
# contention regime (working set >> GPU pool).
SCENARIOS: Dict[str, dict] = {
    "llama8b-a10": dict(
        engine=dict(hardware=A10_PCIE4, num_gpu_blocks=1024,
                    num_cpu_blocks=8192, max_running=32,
                    model_params=8_000_000_000, kv_bytes_per_token=131072),
        workload=dict(rate_req_s=0.4, n_convs=100, max_context=4000),
        update_freq=0.04,          # paper: doubled for the smaller model
    ),
    "qwen32b-a100": dict(
        engine=dict(hardware=A100_PCIE4, num_gpu_blocks=1536,
                    num_cpu_blocks=12288, max_running=32,
                    model_params=32_000_000_000,
                    kv_bytes_per_token=262144),
        workload=dict(rate_req_s=0.4, n_convs=100, max_context=6000),
        update_freq=0.02,
    ),
}

# the paper's ladder: the vLLM baseline, then FastSwitch's three
# mechanisms added one at a time
POLICY_ORDER = ["vllm", "+dbg", "+dbg+reuse", "fastswitch"]


def run_policy(scenario: str, policy: str, pattern: str = "markov",
               update_freq: Optional[float] = None, seed: int = 7,
               engine_overrides: Optional[dict] = None,
               workload_overrides: Optional[dict] = None
               ) -> FastSwitchEngine:
    """Run one (scenario x policy x pattern) serving trace; returns the
    engine (metrics + component stats attached)."""
    sc = SCENARIOS[scenario]
    eng_kw = dict(sc["engine"])
    eng_kw.update(engine_overrides or {})
    wl = dict(sc["workload"])
    wl.update(workload_overrides or {})
    convs = sample_conversations(wl["n_convs"], rate_req_s=wl["rate_req_s"],
                                 seed=seed,
                                 max_context=wl.get("max_context", 6000))
    cfg = EngineConfig(mode="sim", **eng_kw).with_policy(policy)
    freq = update_freq if update_freq is not None else sc["update_freq"]
    eng = FastSwitchEngine(
        cfg, convs, trace=PriorityTrace(pattern, freq, seed=seed))
    eng.run(max_iterations=2_000_000)
    assert eng.done(), f"{scenario}/{policy}: trace did not drain"
    return eng
