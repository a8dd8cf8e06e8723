"""Sampled requests through the port's real engine, at smoke size on the
CPU, against the reference's real engine (tests/test_decode_consistency.py
``test_engine_real_sampling_deterministic_under_seed``) and against the
port's own plain dense forward.

  * under preemption (the storm of tests/test_torch_engine.py) with
    temperature 0.8 and top_p 0.9: the modelled metrics equal the
    reference's; every generated token is the plain sampler's draw from
    the plain dense forward's logits with the request's key
    (``chip_smoke.check_sampled_tokens``), or a stated near-tie; each
    conversation's stream equals the reference's, or first parts from it
    at a stated near-tie; the streams are sampled (they differ from the
    greedy run's) and repeat for the same seed;
  * the same stream for the same seed under two preemption orders.

Near-ties (``chip_smoke.sampled_apart``): the logits of the two packages,
and of the paged and dense paths, differ by bf16 rounding through two
layers, within ``NEAR_TIE`` (tests/test_torch_engine.py's rule for
greedy streams), so a draw may go either way where two tokens' scaled
logits plus Gumbel noise lie within NEAR_TIE / temperature, or where a
token's nucleus mass before it lies within ``chip_smoke.NUCLEUS_EPS`` of
top_p.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

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

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

NEAR_TIE = 2e-2
SAMPLING = (0.8, 0, 0.9)
SEED = 3


@pytest.fixture(scope="module")
def bundles():
    jcfg = jax_smoke_config("qwen2-1.5b")
    jparams = jax_T.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = T.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    return ({"cfg": jcfg, "params": jparams},
            {"cfg": get_smoke_config("qwen2-1.5b"), "params": tparams})


def explain_divergence(bundle, hist_a, hist_b, *, rid, seed, sampling,
                       first_tokens) -> str:
    """Why two sampled histories of request ``rid`` part, from the port's
    plain forward over their shared prefix: "equal" where they do not,
    else ``chip_smoke.sampled_apart``'s reason at the first difference
    ("" where none explains it).  ``first_tokens``: the positions a
    prefill drew (a turn's first token: key salted 1, position
    len(history)); the others a decode step drew (previous position)."""
    n = min(len(hist_a), len(hist_b))
    diff = [i for i in range(n) if hist_a[i] != hist_b[i]]
    if not diff:
        return "equal" if len(hist_a) == len(hist_b) else ""
    i = diff[0]
    with torch.no_grad():
        logits, _, _ = T.forward_seq(bundle["params"], bundle["cfg"],
                                     torch.tensor([hist_a[:i]]))
    first = i in first_tokens
    key = chip_smoke.row_key(seed, rid, salt=1 if first else 0)
    return chip_smoke.sampled_apart(logits[0, -1], key,
                                    i if first else i - 1, sampling,
                                    hist_a[i], hist_b[i], tol=NEAR_TIE)


def _first_tokens(conv):
    pos, firsts = 0, set()
    for turn in conv.turns:
        pos += turn.prompt_tokens
        firsts.add(pos)
        pos += turn.response_tokens
    return firsts


def _storm(conv_cls, turn_cls):
    return [conv_cls(conv_id=i, arrival_s=0.0,
                     turns=[turn_cls(16, 10), turn_cls(8, 6)],
                     think_time_s=0.2) for i in range(4)]


def _run(engine_cls, cfg_cls, trace_cls, conv_cls, turn_cls, bundle,
         sampling=SAMPLING, trace_seed=13):
    t, k, p = sampling
    cfg = cfg_cls(mode="real", num_gpu_blocks=8, num_cpu_blocks=256,
                  max_running=4, max_batch=4, block_size=16,
                  swap_chunk_blocks=1, temperature=t, top_k=k, top_p=p,
                  seed=SEED).with_policy("fastswitch")
    eng = engine_cls(cfg, _storm(conv_cls, turn_cls),
                     trace=trace_cls("random", 0.5, seed=trace_seed),
                     model_bundle=bundle)
    eng.run(max_iterations=20_000)
    assert eng.done()
    return eng


def _port(bundle, **kw):
    return _run(FastSwitchEngine, EngineConfig, PriorityTrace, Conversation,
                Turn, bundle, **kw)


def test_sampled_storm_follows_the_plain_sampler_and_the_reference(bundles):
    jb, tb = bundles
    ja = _run(JaxFastSwitchEngine, JaxEngineConfig, JaxPriorityTrace,
              JaxConversation, JaxTurn, jb)
    ta = _port(tb)
    js, ts = ja.metrics.summary(), ta.metrics.summary()
    js.pop("callstack_wall_s")
    ts.pop("callstack_wall_s")
    assert ts == js and ta.metrics.preemptions > 0
    assert ta.runner.stats.sampled_graphs > 0
    for conv in _storm(Conversation, Turn):
        got = chip_smoke.check_sampled_tokens(ta, tb, conv, SAMPLING,
                                              seed=SEED, tol=NEAR_TIE)
        assert got["equal"] + len(got["near_ties"]) == got["generated"]
        assert len(got["near_ties"]) <= got["generated"] // 4, got
        cid = conv.conv_id
        why = explain_divergence(tb, ta._token_hist_by_conv[cid],
                                 ja._token_hist_by_conv[cid], rid=cid,
                                 seed=SEED, sampling=SAMPLING,
                                 first_tokens=_first_tokens(conv))
        assert why, f"conv {cid}: the streams part without a near-tie"
    again = _port(tb)
    assert again._token_hist_by_conv == ta._token_hist_by_conv
    greedy = _port(tb, sampling=(0.0, 0, 1.0))
    assert greedy._token_hist_by_conv != ta._token_hist_by_conv
    assert greedy.metrics.total_tokens == ta.metrics.total_tokens
    assert greedy.runner.stats.sampled_graphs == 0


def test_same_stream_under_two_preemption_orders(bundles):
    """The stream is a pure function of (seed, rid, position): two storms
    that preempt in other orders give each conversation the same tokens,
    or streams that first part at a near-tie."""
    _, tb = bundles
    a = _port(tb, trace_seed=13)
    b = _port(tb, trace_seed=5)
    assert a.metrics.summary()["ctx_switch_stall_us"] != \
        b.metrics.summary()["ctx_switch_stall_us"]
    for conv in _storm(Conversation, Turn):
        cid = conv.conv_id
        why = explain_divergence(tb, a._token_hist_by_conv[cid],
                                 b._token_hist_by_conv[cid], rid=cid,
                                 seed=SEED, sampling=SAMPLING,
                                 first_tokens=_first_tokens(conv))
        assert why, f"conv {cid}: the streams part without a near-tie"
