"""repro_torch's serving engine against the JAX reference (CPU).

  * sim mode is pure Python on both sides: metrics, TTFT/TBT lists and
    the event log must be identical;
  * real mode (the storm of tests/test_serving_api.py): the modelled
    metrics must be identical (the simulated clock does not depend on
    token values), and the greedy token histories equal — or, where they
    differ, the first divergence is a near-tie of the reference logits;
  * the port imports neither ``jax`` nor any ``repro`` module.
"""
import os
import subprocess
import sys
import textwrap
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import EngineConfig as JaxEngineConfig
from repro.core import FastSwitchEngine as JaxFastSwitchEngine
from repro.core import ServingEngine as JaxServingEngine
from repro.data.priority import PriorityTrace as JaxPriorityTrace
from repro.data.sharegpt import Conversation as JaxConversation
from repro.data.sharegpt import Turn as JaxTurn
from repro.data.sharegpt import sample_conversations as jax_sample_convs
from repro.models import transformer as jax_T
from repro_torch.configs import get_smoke_config
from repro_torch.core import EngineConfig, FastSwitchEngine, ServingEngine
from repro_torch.core import SamplingParams
from repro_torch.data.priority import PriorityTrace
from repro_torch.data.sharegpt import Conversation, Turn, sample_conversations
from repro_torch.models import transformer as T
from torch_threads import one_torch_thread  # noqa: E402,F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# a greedy divergence between the packages is accepted only where the
# reference's top-2 logits are this close: bf16 activations through two
# layers differ by rounding between XLA and PyTorch, which can flip a
# near-tie but not a clear winner (the smoke model's logit spread is O(1))
NEAR_TIE = 2e-2


# ---------------------------------------------------------------------------
# sim mode
# ---------------------------------------------------------------------------


def _sim_run(engine_cls, cfg_cls, trace_cls, convs, **cfg_kw):
    cfg = cfg_cls(mode="sim", num_gpu_blocks=256, num_cpu_blocks=1024,
                  max_running=8, **cfg_kw).with_policy("fastswitch")
    eng = engine_cls(cfg, convs, trace=trace_cls("markov", 0.04, seed=7))
    m = eng.run(max_iterations=300_000)
    assert eng.done()
    return eng, m


@pytest.mark.parametrize("policy_kw", [{}, {"swap_chunk_blocks": 4}])
def test_sim_replay_identical(policy_kw):
    jc = jax_sample_convs(24, seed=3)
    tc = sample_conversations(24, seed=3)
    ja, jm = _sim_run(JaxFastSwitchEngine, JaxEngineConfig, JaxPriorityTrace,
                      jc, **policy_kw)
    ta, tm = _sim_run(FastSwitchEngine, EngineConfig, PriorityTrace, tc,
                      **policy_kw)
    js, ts = jm.summary(), tm.summary()
    js.pop("callstack_wall_s")
    ts.pop("callstack_wall_s")
    assert ts == js
    assert tm.preemptions > 0
    assert tm.ttfts_us == jm.ttfts_us
    assert tm.tbts_us == jm.tbts_us
    assert ta.swap.stats() == ja.swap.stats()


def _online_sim(engine_cls, cfg_cls, trace_cls, sp_cls):
    cfg = cfg_cls(mode="sim", num_gpu_blocks=48, num_cpu_blocks=512,
                  max_running=6).with_policy("fastswitch")
    eng = engine_cls(cfg, trace=trace_cls("random", 0.3, seed=5))
    handles = [eng.add_request(40 + 9 * i, sp_cls(max_tokens=12 + i),
                               retain_kv=True) for i in range(8)]
    it = 0
    while eng.has_work() and it < 20_000:
        for out in eng.step():
            if out.finished and out.turn == 0 and out.handle % 2 == 0:
                eng.continue_session(out.handle, 16, sp_cls(max_tokens=6))
        it += 1
    eng.abort(handles[1])
    return eng


def test_sim_online_event_log_identical():
    from repro.core import SamplingParams as JaxSamplingParams
    ja = _online_sim(JaxServingEngine, JaxEngineConfig, JaxPriorityTrace,
                     JaxSamplingParams)
    ta = _online_sim(ServingEngine, EngineConfig, PriorityTrace,
                     SamplingParams)
    assert [e.as_dict() for e in ta.events] == \
        [e.as_dict() for e in ja.events]
    assert ta.metrics.ttfts_us == ja.metrics.ttfts_us
    assert ta.metrics.tbts_us == ja.metrics.tbts_us
    assert ta.metrics.slo_summary() == ja.metrics.slo_summary()


# ---------------------------------------------------------------------------
# real mode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bundles():
    jcfg = jax_smoke_config("qwen2-1.5b")
    jparams = jax_T.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = T.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    return ({"cfg": jcfg, "params": jparams},
            {"cfg": get_smoke_config("qwen2-1.5b"), "params": tparams})


def _storm_cfg(cfg_cls, policy="fastswitch", chunk=0):
    cfg = cfg_cls(mode="real", num_gpu_blocks=8, num_cpu_blocks=256,
                  max_running=4, max_batch=4, block_size=16,
                  swap_chunk_blocks=1).with_policy(policy)
    if chunk:
        cfg = replace(cfg, policy=replace(cfg.policy,
                                          chunked_prefill_tokens=chunk))
    return cfg


def _storm(conv_cls, turn_cls, turns=((16, 10), (8, 6))):
    return [conv_cls(conv_id=i, arrival_s=0.0,
                     turns=[turn_cls(p, r) for p, r in turns],
                     think_time_s=0.2) for i in range(4)]


def first_divergence_gap(params, cfg, hist_a, hist_b):
    """(index, top-2 logit gap at it) of the first position where two
    greedy histories differ, from the port's plain forward over the
    shared prefix; None when they are equal."""
    n = min(len(hist_a), len(hist_b))
    for i in range(n):
        if hist_a[i] != hist_b[i]:
            toks = torch.tensor([hist_a[:i]], dtype=torch.long)
            logits, _, _ = T.forward_seq(params, cfg, toks)
            top2 = torch.topk(logits[0, -1], 2).values
            return i, float(top2[0] - top2[1])
    assert len(hist_a) == len(hist_b)
    return None


# (policy, chunked prefill tokens, turns): the storm of
# tests/test_serving_api.py, then the paths it does not reach — prefill in
# block-sized chunks with mid-prefill preemption, recompute-mode resumes
# (re-prefill without a first token), and synchronous whole-context swaps
STORMS = {
    "fastswitch": ("fastswitch", 0, ((16, 10), (8, 6))),
    "chunked": ("fastswitch", 16, ((40, 8), (24, 6))),
    "recompute": ("vllm-recompute", 0, ((16, 10), (8, 6))),
    "vllm": ("vllm", 0, ((16, 10), (8, 6))),
}


@pytest.mark.parametrize("storm", sorted(STORMS))
def test_real_storm_matches_reference(bundles, storm):
    policy, chunk, turns = STORMS[storm]
    jb, tb = bundles
    ja = JaxFastSwitchEngine(_storm_cfg(JaxEngineConfig, policy, chunk),
                             _storm(JaxConversation, JaxTurn, turns),
                             trace=JaxPriorityTrace("random", 0.5, seed=13),
                             model_bundle=jb)
    ja.run(max_iterations=20_000)
    ta = FastSwitchEngine(_storm_cfg(EngineConfig, policy, chunk),
                          _storm(Conversation, Turn, turns),
                          trace=PriorityTrace("random", 0.5, seed=13),
                          model_bundle=tb)
    ta.run(max_iterations=20_000)
    assert ja.done() and ta.done()
    js, ts = ja.metrics.summary(), ta.metrics.summary()
    js.pop("callstack_wall_s")
    ts.pop("callstack_wall_s")
    assert ts == js
    assert ta.metrics.preemptions > 0
    if chunk:
        assert ta.runner.stats.prefill_chunks > ta.runner.stats.prefills
        assert ta.runner.stats.prefill_chunks == ja.runner.stats.prefill_chunks
    assert ta.metrics.ttfts_us == ja.metrics.ttfts_us
    assert ta.metrics.tbts_us == ja.metrics.tbts_us
    # a conflict counts only while the other task is still listed, and a
    # task past its modelled completion leaves the list only once its
    # worker thread's copy has finished in real time: the two packages'
    # copies take different real times, so n_conflicts and n_syncs may
    # differ by such waits, which add no modelled time (the stall is
    # compared with everything else)
    js_swap, ts_swap = ja.swap.stats(), ta.swap.stats()
    for racy in ("n_conflicts", "n_syncs"):
        js_swap.pop(racy)
        ts_swap.pop(racy)
    assert ts_swap == js_swap
    assert (ta.pools.staged_out_calls, ta.pools.staged_in_calls) == \
        (ja.pools.staged_out_calls, ja.pools.staged_in_calls)
    if policy != "vllm-recompute":
        assert ta.pools.staged_out_calls > 0 and ta.pools.staged_in_calls > 0
    assert set(ta._token_hist_by_conv) == set(ja._token_hist_by_conv)
    for cid, jh in ja._token_hist_by_conv.items():
        d = first_divergence_gap(tb["params"], tb["cfg"],
                                 ta._token_hist_by_conv[cid], jh)
        assert d is None or d[1] < NEAR_TIE, \
            f"conv {cid}: histories diverge at {d[0]} with gap {d[1]}"


def test_port_refuses_what_it_does_not_serve(bundles):
    _, tb = bundles
    cfg = _storm_cfg(EngineConfig)
    # a mesh is served now: the default device list (the CUDA devices
    # present) that is too short is refused with the reference's
    # ValueError, and shards on more than one device are not served
    with pytest.raises(ValueError, match="devices"):
        ServingEngine(replace(cfg, mesh_shape=(1, 64)), model_bundle=tb)
    with pytest.raises(NotImplementedError, match="2 devices"):
        ServingEngine(replace(cfg, mesh_shape=(1, 2)),
                      model_bundle={**tb, "mesh_devices": ["cuda:0",
                                                           "cuda:1"]})
    # the prefix cache is served now, and refused where the reference
    # refuses it: in sim mode and under a policy without reuse
    assert ServingEngine(replace(cfg, prefix_cache=True),
                         model_bundle=tb).prefix is not None
    with pytest.raises(ValueError, match="mode='real'"):
        ServingEngine(replace(cfg, mode="sim", prefix_cache=True))
    with pytest.raises(ValueError, match="reuse-enabled"):
        ServingEngine(replace(_storm_cfg(EngineConfig, "vllm"),
                              prefix_cache=True), model_bundle=tb)
    # sampling is served now: a request with temperature > 0 finishes
    eng = ServingEngine(replace(cfg, temperature=0.7), model_bundle=tb)
    eng.add_request(list(range(1, 20)),
                    SamplingParams(max_tokens=4, temperature=0.5))
    outs = []
    while eng.has_work():
        outs.extend(eng.step())
    assert [o.finish_reason for o in outs if o.finished] == ["length"]


# ---------------------------------------------------------------------------
# no jax, no repro
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module imports with ``jax`` blocked, and no
    ``repro`` module gets loaded; chip_smoke.py's imports too."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None           # any `import jax` now fails
        import repro_torch
        names = ["repro_torch"]
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            names.append(m.name)
            importlib.import_module(m.name)
        import chip_smoke                   # module level only, no run
        bad = sorted(n for n in sys.modules
                     if n == "repro" or n.startswith("repro."))
        assert not bad, bad
        print(len(names))
    """)
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, root]))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 25
