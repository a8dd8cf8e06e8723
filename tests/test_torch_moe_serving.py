"""The port's MoE serving path on olmoe-1b-7b's smoke config against the
reference's (CPU, the reference's weights converted), at the config's
capacity factor 4.0 (dropless: K / E * 4.0 = 2 slots per token) and at
1.0, where pairs really drop (every prefill chunk, and a decode bucket of
8 rows):

  * ``forward_seq`` and the paged decode step at a bucket of 8 rows (one
    of them freed) against the reference's ``forward_seq`` and
    ``paged_decode_step_device``, and chunked prefill against its
    ``prefill_kv_chunk`` run op by op (``jax.disable_jit``), which rounds
    every bf16 op as the port does (tolerances of
    tests/test_torch_model.py).  Jitted, XLA keeps fused bf16
    intermediates in fp32, and that alone flips a routing near-tie of the
    prefill's tokens: a K-th to (K+1)-th probability gap of 4e-4 at
    position 24 routes to another expert there, which moves that token's
    layer-1 K by up to 2.06;
  * the real-mode ``ServingEngine`` under the preemption storm of
    tests/test_torch_engine.py, and the launcher's real online smoke
    (``--arch olmoe-1b-7b --real --device cpu``): modelled clocks,
    ``EngineMetrics``, swap statistics and event logs equal; token
    histories equal, or differing first at a near-tie of the logits or
    of the routing of the engine call that produced the token
    (``EngineGaps``), against the jitted reference, in fewer than half
    the conversations.

A MoE row's output depends on the other rows of its call through
capacity (the reference's semantics), so these hold the port's row
layout, padding and pad tokens to the reference's as well.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core import EngineConfig as JaxEngineConfig
from repro.core import FastSwitchEngine as JaxFastSwitchEngine
from repro.data.priority import PriorityTrace as JaxPriorityTrace
from repro.data.sharegpt import Conversation as JaxConversation
from repro.data.sharegpt import Turn as JaxTurn
from repro.kernels import ops as jax_ops
from repro.launch import serve as jax_serve
from repro.models import transformer as jax_T
from repro.models.params import count_params_analytic as jax_count
from repro.models.paged import paged_decode_step_device as jax_decode_step
from repro_torch import configs
from repro_torch.core import EngineConfig, FastSwitchEngine
from repro_torch.data.priority import PriorityTrace
from repro_torch.data.sharegpt import Conversation, Turn
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.paged import paged_decode_step_device
from repro_torch.models.params import count_params_analytic
from test_torch_engine import NEAR_TIE, STORMS, _storm, _storm_cfg
from test_torch_model import BS, KV_TOL, LOGIT_TOL, assert_close_bf16, \
    check_forward_seq
from test_torch_serve import _launch, swaps_follow_the_clock  # noqa: F401
from torch_threads import one_torch_thread  # noqa: E402,F401

ARCH = "olmoe-1b-7b"
FACTORS = (4.0, 1.0)


def with_factor(cfg, cf: float):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_configs.get_smoke_config(ARCH)
    jparams = jax_T.init_params(jcfg, jax.random.PRNGKey(0))
    return jparams, T.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")


@pytest.fixture(params=FACTORS, ids=[f"cf{cf}" for cf in FACTORS])
def model(request, weights):
    """(reference cfg, reference params, port cfg, port params) at one
    capacity factor."""
    cf = request.param
    return (with_factor(jax_configs.get_smoke_config(ARCH), cf), weights[0],
            with_factor(configs.get_smoke_config(ARCH), cf), weights[1])


@pytest.fixture
def drops(monkeypatch):
    """Counts the pairs the port's MoE layers drop, over all calls."""
    seen = {"pairs": 0, "dropped": 0}
    real = moe.route

    def route(router, xf, m):
        plan = real(router, xf, m)
        seen["pairs"] += plan.slot.numel()
        seen["dropped"] += int((plan.slot == plan.capacity).sum())
        return plan
    monkeypatch.setattr(moe, "route", route)
    return seen


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_row_matches_reference(getter):
    want = getattr(jax_configs, getter)(ARCH)
    got = getattr(configs, getter)(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert count_params_analytic(got) == jax_count(want)
    assert count_params_analytic(got, active_only=True) == \
        jax_count(want, active_only=True)
    T.check_supported(got)


def test_full_config_is_inside_the_paged_kernels_guards():
    cfg = configs.get_config(ARCH)
    assert cfg.resolved_head_dim == 128
    assert cfg.n_heads == cfg.n_kv_heads == 16           # GQA group 1
    assert count_params_analytic(cfg) == 6_919_096_320
    m = cfg.moe
    assert (m.n_experts, m.top_k, m.d_expert_ff) == (64, 8, 1024)
    # the engine's decode bucket of 8 rows: 4 slots per expert
    assert moe.capacity(8, m) == 4


def test_forward_seq_matches_reference(model, drops):
    check_forward_seq(model)
    assert drops["pairs"] > 0
    if model[2].moe.capacity_factor == 1.0:
        assert drops["dropped"] > 0


def test_decode_step_matches_reference(model, drops):
    """One ``paged_decode_step_device`` step at a bucket of 8 rows (the
    last freed: trash block, context 0) on both sides from the same pool
    bytes: equal greedy tokens and context/token updates, the new K/V
    within bf16 tolerance and the rest of the pool byte-equal."""
    cfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(2)
    B, P, nb = 8, 4, 40
    pool = (rng.standard_normal((cfg.n_layers, 2, nb, BS, cfg.n_kv_heads,
                                 cfg.resolved_head_dim)) * 0.5
            ).astype(np.float32)
    pool_bf = jnp.asarray(pool, jnp.bfloat16)
    bt = rng.permutation(nb - 1)[:B * P].reshape(B, P).astype(np.int32)
    bt[B - 1] = nb - 1
    ctx = np.asarray([5, 17, 40, 63, 1, 30, 9, 0], np.int32)
    tok = rng.integers(1, cfg.vocab_size, B).astype(np.int32)
    active = np.arange(B) < B - 1
    keys = np.zeros((B, 2), np.uint32)
    smp = np.zeros((B, 3), np.float32)
    jn, jpool, jctx, jtok = jax_decode_step(
        jparams, jnp.array(pool_bf), jnp.asarray(bt), jnp.asarray(ctx),
        jnp.asarray(tok), jnp.asarray(active), jnp.asarray(keys),
        jnp.asarray(smp), cfg=cfg)
    tpool = torch.from_numpy(np.asarray(pool_bf).view(np.int16)
                             ).view(torch.bfloat16).clone()
    t = torch.from_numpy
    tctx, ttok = t(ctx).clone(), t(tok).clone()
    n, tpool, tctx, ttok = paged_decode_step_device(
        T.serving_params(tparams), tpool, t(bt), tctx, ttok, t(active),
        t(keys.astype(np.int64)), t(smp), cfg=tcfg)
    real = B - 1
    np.testing.assert_array_equal(n.numpy()[:real], np.asarray(jn)[:real])
    np.testing.assert_array_equal(tctx.numpy(), np.asarray(jctx))
    np.testing.assert_array_equal(ttok.numpy()[:real],
                                  np.asarray(jtok)[:real])
    got = tpool.float().numpy()
    want = np.asarray(jpool, np.float32)
    assert_close_bf16(got, want, KV_TOL)
    untouched = np.ones(got.shape[2:4], bool)
    for b in range(real):
        untouched[bt[b, ctx[b] // BS], ctx[b] % BS] = False
    untouched[nb - 1] = False
    np.testing.assert_array_equal(got[:, :, untouched], want[:, :, untouched])
    # capacity 4 per expert over 8 rows x 2 pairs: the tight factor drops
    assert drops["pairs"] == cfg.n_layers * B * cfg.moe.top_k
    if tcfg.moe.capacity_factor == 1.0:
        assert drops["dropped"] > 0


def test_prefill_chunks_match_reference(model, drops):
    """Chunked prefill (each chunk padded to its pow2 bucket with token 0,
    as both packages pad it) through ``ops.prefill_chunk``, 44 tokens in
    chunks of 16, 16 and 12 over the carry: last logits and carries within
    tolerance of the reference's, run op by op."""
    cfg, jparams, tcfg, tparams = model
    toks = np.random.RandomState(0).randint(1, cfg.vocab_size, 44).tolist()
    jkc = jvc = tkc = tvc = None
    pos = 0
    for n in (16, 16, 12):
        with jax.disable_jit():
            jl, jkc, jvc, _, _ = jax_ops.prefill_chunk(
                jparams, toks[pos:pos + n], jkc, jvc, pos, cfg=cfg,
                block_size=BS)
        tl, tkc, tvc, _, _ = ops.prefill_chunk(
            T.serving_params(tparams), toks[pos:pos + n], tkc, tvc, pos,
            cfg=tcfg, block_size=BS)
        pos += n
        assert_close_bf16(tl.numpy(), jl, LOGIT_TOL)
    assert_close_bf16(tkc[:, :pos].float().numpy(), jkc[:, :pos], KV_TOL)
    assert_close_bf16(tvc[:, :pos].float().numpy(), jvc[:, :pos], KV_TOL)
    assert int(torch.argmax(tl)) == int(jnp.argmax(jl))
    if tcfg.moe.capacity_factor == 1.0:
        assert drops["dropped"] > 0


# a MoE router flips an expert where a token's K-th and (K+1)-th
# probabilities lie closer than the rounding of its bf16 input moves them:
# the jitted reference keeps fused bf16 intermediates in fp32, so ~1 % of
# a layer's inputs sit an ulp (2^-8 relative) away from the port's, which
# moves the smoke router's probabilities by ~1e-4; this is 10x that.  A
# flip moves the token's hidden state by a whole expert's output, which
# no logit tolerance covers.
ROUTE_TIE = 1e-3


class EngineGaps:
    """Records, while the port's engine runs, the gaps of each engine call
    that produced a token, as the engine itself computed them: a decode
    step's row its top-2 logit gap and its own least routing gap (K-th to
    (K+1)-th probability, over the layers); a prefill chunk its last
    logits' top-2 gap and the least routing gap over the chunk's
    positions.  Decode steps route the whole bucket at once and prefill
    chunks their padded chunk, so a plain forward over a history (whose
    capacity counts other tokens) is not the engine's computation.  Each
    call's record is keyed by the tokens before the token it produced."""

    def __init__(self, monkeypatch):
        from repro_torch.core import decode_runner as dr
        from repro_torch.models import paged
        self.calls = []          # (history before the token, logit, route)
        self.dropped = 0                    # pairs past capacity
        self._gaps, self._logits = [], None
        real_route, real_sample = moe.route, paged.sample_tokens
        rec = self

        def route(router, xf, m):
            plan = real_route(router, xf, m)
            top = torch.sort(plan.probs, dim=-1, descending=True).values
            rec._gaps.append(top[:, m.top_k - 1] - top[:, m.top_k])
            rec.dropped += int((plan.slot == plan.capacity).sum())
            return plan

        def sample_tokens(logits, *a, **k):
            rec._logits = logits
            return real_sample(logits, *a, **k)

        stage, compute = (dr.DecodeRunner._stage_tokens,
                          dr.DecodeRunner.prefill_chunk_compute)

        def _stage_tokens(runner, nxt, rows_hist):
            gaps = torch.stack(rec._gaps).min(dim=0).values
            for row, hist in rows_hist:
                rec.calls.append((tuple(hist), _top2(rec._logits[row]),
                                  float(gaps[row])))
            rec._gaps = []
            return stage(runner, nxt, rows_hist)

        def prefill_chunk_compute(runner, rid, n_tokens):
            st = runner._prefills[rid]
            pos, toks = st.pos, list(st.toks)
            rec._gaps = []
            out = compute(runner, rid, n_tokens)
            if rec._gaps:
                gaps = torch.stack(rec._gaps).min(dim=0).values
                rec.calls.append((tuple(toks[:pos + n_tokens]),
                                  _top2(st.last_logits),
                                  float(gaps[:n_tokens].min())))
            rec._gaps = []
            return out

        monkeypatch.setattr(moe, "route", route)
        monkeypatch.setattr(paged, "sample_tokens", sample_tokens)
        monkeypatch.setattr(dr.DecodeRunner, "_stage_tokens", _stage_tokens)
        monkeypatch.setattr(dr.DecodeRunner, "prefill_chunk_compute",
                            prefill_chunk_compute)

    def at(self, hist, p):
        """(top-2 logit gap, least routing gap) of the call that produced
        token p of the history ``hist`` (the least over such calls)."""
        found = [(lg, rg) for key, lg, rg in self.calls
                 if len(key) == p and tuple(hist[:p]) == key]
        assert found, f"no engine call produced position {p}"
        return min(lg for lg, _ in found), min(rg for _, rg in found)


def _top2(logits) -> float:
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def _histories_agree(gaps: EngineGaps, got: dict, want: dict) -> list:
    """Equal, or the first difference at a near-tie of the engine call
    that produced it: of its logits, or of its row's routing.  Fewer
    than half the conversations may differ at all.  Prints and returns
    the divergences (conv, index, logit gap, routing gap)."""
    assert set(got) == set(want)
    seen = []
    for cid, jh in want.items():
        th = got[cid]
        i = next((i for i, (x, y) in enumerate(zip(th, jh)) if x != y),
                 None)
        if i is None:
            assert len(th) == len(jh)
            continue
        logit_gap, route_gap = gaps.at(th, i)
        seen.append((cid, i, logit_gap, route_gap))
        assert logit_gap < NEAR_TIE or route_gap < ROUTE_TIE, \
            f"conv {cid}: histories diverge at {i}, where the engine " \
            f"call's logit gap is {logit_gap} and its routing gap " \
            f"{route_gap}"
    print(f"{len(seen)} of {len(want)} conversations diverge: {seen}")
    assert 2 * len(seen) < len(want), seen
    return seen


def test_real_storm_matches_reference(model, monkeypatch,
                                     swaps_follow_the_clock):
    """The fastswitch storm of tests/test_torch_engine.py (4 two-turn
    conversations, 8 GPU blocks, preemption and swaps both ways), swap
    tasks of both packages held to the simulated clock."""
    cfg, jparams, tcfg, tparams = model
    gaps = EngineGaps(monkeypatch)
    policy, chunk, turns = STORMS["fastswitch"]
    ja = JaxFastSwitchEngine(_storm_cfg(JaxEngineConfig, policy, chunk),
                             _storm(JaxConversation, JaxTurn, turns),
                             trace=JaxPriorityTrace("random", 0.5, seed=13),
                             model_bundle={"cfg": cfg, "params": jparams})
    ja.run(max_iterations=20_000)
    ta = FastSwitchEngine(_storm_cfg(EngineConfig, policy, chunk),
                          _storm(Conversation, Turn, turns),
                          trace=PriorityTrace("random", 0.5, seed=13),
                          model_bundle={"cfg": tcfg, "params": tparams})
    ta.run(max_iterations=20_000)
    assert ja.done() and ta.done()
    js, ts = ja.metrics.summary(), ta.metrics.summary()
    js.pop("callstack_wall_s")
    ts.pop("callstack_wall_s")
    assert ts == js
    assert ta.metrics.preemptions > 0
    assert ta.metrics.ttfts_us == ja.metrics.ttfts_us
    assert ta.metrics.tbts_us == ja.metrics.tbts_us
    assert ta.swap.stats() == ja.swap.stats()
    assert ta.pools.staged_out_calls > 0 and ta.pools.staged_in_calls > 0
    _histories_agree(gaps, ta._token_hist_by_conv, ja._token_hist_by_conv)
    assert gaps.calls
    if tcfg.moe.capacity_factor == 1.0:
        assert gaps.dropped > 0


def _recording(monkeypatch, module, seen: list):
    """Make ``module.ServingEngine`` (as the launchers import it) record
    every engine it builds in ``seen``."""
    base = module.ServingEngine

    class Recorded(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self)
    monkeypatch.setattr(module, "ServingEngine", Recorded)


def test_real_launcher_matches_reference(weights, tmp_path, capsys,
                                         monkeypatch, swaps_follow_the_clock):
    """The launcher's real online smoke on olmoe's smoke config (capacity
    factor 4.0): the port's ``--device cpu`` run gives the reference's
    results, printed lines and event log, and its engine's token
    histories equal the reference engine's or differ first at a
    near-tie.  Both serve the reference's weights for seed 0: the port's
    launcher draws its own init otherwise (a different generator)."""
    import repro.core as jax_core
    import repro_torch.core as torch_core
    gaps = EngineGaps(monkeypatch)
    # the launcher draws its serving copy with ``init_params(serving=True)``
    monkeypatch.setattr(
        T, "init_params", lambda cfg, seed, device, serving=False:
        T.serving_params(weights[1]) if serving else weights[1])
    engines = {"ref": [], "port": []}
    _recording(monkeypatch, jax_core, engines["ref"])
    _recording(monkeypatch, torch_core, engines["port"])
    argv = ["--online", "--smoke", "--real", "--arch", ARCH]
    want, want_ev, want_lines = _launch(jax_serve, argv, tmp_path, "ref",
                                        capsys, monkeypatch)
    got, got_ev, got_lines = _launch(serve, [*argv, "--device", "cpu"],
                                     tmp_path, "port", capsys, monkeypatch)
    assert got.pop("kernel_launches") == {"paged_attention": 0,
                                          "block_gather_runs": 0,
                                          "block_scatter_runs": 0}
    histories = got.pop("token_histories")
    assert got == want and got["preemptions"] > 0
    assert got_ev == want_ev
    assert got_lines == want_lines
    assert serve.validate_event_log(str(tmp_path / "port.jsonl")) > 0
    (ref,), (port,) = engines["ref"], engines["port"]
    assert histories == {str(h): t for h, t in
                         port._token_hist_by_conv.items()}
    _histories_agree(gaps, port._token_hist_by_conv, ref._token_hist_by_conv)


def test_launcher_bundle_is_the_serving_copy():
    """``--device cpu`` serves the smoke config from a bundle whose matmul
    weights are bf16 and whose router and norms stay fp32: no fp32
    expert tree beside the serving copy, and each runner keeps the
    bundle's tensors (``serving_params`` of it copies nothing)."""
    bundle = serve._build_real_bundle(ARCH, 0, "cpu")
    assert bundle["cfg"] == configs.get_smoke_config(ARCH)
    ffn = bundle["params"]["layers"]["ffn"]
    assert {k: v.dtype for k, v in ffn.items()} == {
        "router": torch.float32, "w_gate": torch.bfloat16,
        "w_up": torch.bfloat16, "w_down": torch.bfloat16}
    assert bundle["params"]["layers"]["ln2"]["scale"].dtype == torch.float32
    again = T.serving_params(bundle["params"])
    assert all(again["layers"]["ffn"][k] is v for k, v in ffn.items())
