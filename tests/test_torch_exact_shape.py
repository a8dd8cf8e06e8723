"""repro_torch's exact-shape data plane against the JAX package's (CPU):
``paged_decode_step`` and ``prefill_kv`` of ``models/paged.py`` on the
qwen2-1.5b smoke config with the reference's weights, within the bf16
bounds of tests/test_torch_model.py; then the port's real-mode engine
held to its own exact-shape greedy path (``prefill_kv`` +
``PagedPools.write_tokens`` + ``paged_decode_step``, chip_smoke's
``exact_shape_history``), as tests/test_decode_consistency.py holds the
reference's engine to its pre-refactor replay.  A token the engine
generated may differ from the oracle's only at a near-tie of the
oracle's logits (chip_smoke.NEAR_TIE, 0.05), and the comparison of that
conversation ends there."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.paged import paged_decode_step as jax_decode_step
from repro.models.paged import prefill_kv as jax_prefill_kv
from repro_torch.core import EngineConfig, FastSwitchEngine
from repro_torch.data.priority import PriorityTrace
from repro_torch.data.sharegpt import Conversation, Turn
from repro_torch.models.paged import paged_decode_step, prefill_kv
from test_torch_model import (BS, KV_TOL, LOGIT_TOL, assert_close_bf16,
                              smoke_models)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def model():
    return smoke_models("qwen2-1.5b")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_prefill_kv_matches_reference(model):
    cfg, jparams, tcfg, tparams = model
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size, (1, 37))
    jl, jk, jv = jax_prefill_kv(jparams, jnp.asarray(toks, jnp.int32),
                                cfg=cfg)
    tl, tk, tv = prefill_kv(tparams, _t(toks), cfg=tcfg)
    assert tl.shape == (cfg.vocab_size,) and tk.shape == jk.shape
    assert_close_bf16(tl.numpy(), jl, LOGIT_TOL)
    assert_close_bf16(tk.float().numpy(), jk, KV_TOL)
    assert_close_bf16(tv.float().numpy(), jv, KV_TOL)
    assert int(torch.argmax(tl)) == int(jnp.argmax(jl))


@pytest.mark.parametrize("ctx", [[5, 17, 40], [0, 31, 32], [63]])
def test_paged_decode_step_matches_reference(model, ctx):
    """One exact-shape step on both sides from the same pool bytes (no
    bucket, no trash rows): equal greedy tokens, logits within bf16
    tolerance, each row's new K/V within it, and every other pool byte
    equal; the port writes its pool in place."""
    cfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(len(ctx) + ctx[0])
    B, nb = len(ctx), 24
    P = max(c // BS + 1 for c in ctx)
    pool = (rng.standard_normal((cfg.n_layers, 2, nb, BS, cfg.n_kv_heads,
                                 cfg.resolved_head_dim)) * 0.5
            ).astype(np.float32)
    pool_bf = np.asarray(jnp.asarray(pool, jnp.bfloat16))
    bt = rng.permutation(nb)[:B * P].reshape(B, P).astype(np.int32)
    ctx = np.asarray(ctx, np.int32)
    tok = rng.integers(1, cfg.vocab_size, B).astype(np.int32)
    jn, jlogits, jpool = jax_decode_step(
        jparams, jnp.asarray(pool_bf), jnp.asarray(bt), jnp.asarray(ctx),
        jnp.asarray(tok), cfg=cfg)
    tpool = torch.from_numpy(pool_bf.view(np.int16).copy()).view(
        torch.bfloat16)
    n, logits, out = paged_decode_step(tparams, tpool, _t(bt), _t(ctx),
                                       _t(tok), cfg=tcfg)
    assert out is tpool and n.dtype == torch.int32
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert_close_bf16(logits.numpy(), jlogits, LOGIT_TOL)
    got, want = tpool.float().numpy(), np.asarray(jpool, np.float32)
    assert_close_bf16(got, want, KV_TOL)
    untouched = np.ones(got.shape[2:4], bool)
    for b in range(B):
        untouched[bt[b, ctx[b] // BS], ctx[b] % BS] = False
    np.testing.assert_array_equal(got[:, :, untouched], want[:, :, untouched])


def _engine(tcfg, tparams, convs, **kw):
    cfg = EngineConfig(**{"mode": "real", "num_cpu_blocks": 256,
                          "max_running": 4, "max_batch": 4,
                          "block_size": 16, **kw}).with_policy("fastswitch")
    return FastSwitchEngine(cfg, convs,
                            trace=PriorityTrace("random", 0.5, seed=13),
                            model_bundle={"cfg": tcfg, "params": tparams})


@pytest.mark.parametrize("workload", ["storm", "preemption_swap"])
def test_engine_tokens_equal_the_exact_shape_oracle(model, workload):
    """The port's real-mode engine under a priority storm, swaps held to
    the clock: chip_smoke's engine-phase workload at smoke size, and the
    preemption-and-swap schedule of tests/test_decode_consistency.py
    (8 blocks, one-block swap chunks).  Every conversation's history
    equals the exact-shape oracle's, or first differs at a near-tie."""
    _, _, tcfg, tparams = model
    if workload == "storm":
        convs = chip_smoke.conversations(8, (256, 288, 320, 352),
                                         (96, 128, 160), max_tokens=32)
        eng = _engine(tcfg, tparams, convs, num_gpu_blocks=160,
                      num_cpu_blocks=1024, max_running=8, max_batch=8)
    else:
        convs = [Conversation(conv_id=i, arrival_s=0.0,
                              turns=[Turn(16, 12), Turn(8, 8)],
                              think_time_s=0.2) for i in range(4)]
        eng = _engine(tcfg, tparams, convs, num_gpu_blocks=8,
                      swap_chunk_blocks=1)
    with chip_smoke.swaps_follow_the_clock():
        eng.run(max_iterations=100_000)
    eng.shutdown()
    assert eng.done()
    assert eng.metrics.preemptions > 0 and eng.metrics.swap_in_count > 0
    res = chip_smoke.check_oracle(eng, {"cfg": tcfg, "params": tparams},
                                  convs)
    assert res["conversations"] == len(convs)
    assert res["equal"] + len(res["near_ties"]) == len(convs)
    assert all(d["logit_gap"] < chip_smoke.NEAR_TIE
               for d in res["near_ties"])
    print(f"{workload}: {res['equal']} of {len(convs)} equal, near-ties "
          f"{res['near_ties']}")


def test_oracle_catches_a_wrong_engine_token(model):
    """The oracle's own history passes; a history whose last token is
    another fails unless the rule's tolerance covers the logit gap."""
    _, _, tcfg, tparams = model
    conv = Conversation(conv_id=0, arrival_s=0.0, turns=[Turn(20, 4)],
                        think_time_s=0.0)
    bundle = {"cfg": tcfg, "params": tparams}
    hist = chip_smoke.exact_shape_history(bundle, conv, None)["history"]
    assert len(hist) == 24
    rec = chip_smoke.exact_shape_history(bundle, conv, hist)
    assert rec["first_difference"] is None and rec["generated"] == 4
    wrong = hist[:-1] + [(hist[-1] + 1) % tcfg.vocab_size]
    with pytest.raises(AssertionError, match="below the exact-shape"):
        chip_smoke.exact_shape_history(bundle, conv, wrong, tol=1e-9)
    rec = chip_smoke.exact_shape_history(bundle, conv, wrong, tol=1e9)
    assert rec["first_difference"]["position"] == 23
