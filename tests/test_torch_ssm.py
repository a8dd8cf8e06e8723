"""repro_torch's SSM and hybrid families against the JAX package's (CPU,
smoke configs, the reference's weights converted with
``params_from_numpy``, the same numpy inputs):

  * the Mamba2 and RWKV6 blocks' sequence forward (from the zero state and
    from a given one) and decode step;
  * for zamba2-7b's smoke config (one period of a Mamba2 layer and the
    shared attention block, and one remainder Mamba2 layer) and
    rwkv6-1.6b's: the parameter tree and count, ``serving_params``,
    ``forward_seq`` logits and caches, ``init_caches`` and ``serve_step``s
    from them (bf16 and int8 attention K/V), ``prefill`` ->
    ``caches_from_prefill`` -> ``serve_step``s;
  * ``check_supported`` (which passes every registry arch) and the paged
    path's refusals, and
    ``launch.serve --real``'s refusal with the reference's message.
tests/test_torch_ssm_train.py holds the training path and its launcher.

The reference runs op by op (``jax.disable_jit``), which rounds every bf16
op as the port does; its bounds are tests/test_torch_model.py's (logits
3e-2 per element and 5e-3 on the mean, bf16 caches 5e-2).  The reference
jitted against itself op by op, on these smoke configs: logits up to
0.0154 (zamba2) and 0 (rwkv6), bf16 caches up to 0.031; the port against
op by op: logits up to 0.0087 and 0.0066, bf16 caches up to 0.0156.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jax_serve
from repro.models import mamba2 as jax_mamba2
from repro.models import rwkv6 as jax_rwkv6
from repro.models import steps as jax_S
from repro.models import transformer as jax_T
from repro.models.params import count_params_analytic as jax_count
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import mamba2, rwkv6
from repro_torch.models import steps as S
from repro_torch.models import transformer as T
from repro_torch.models.paged import check_paged
from repro_torch.models.params import count_params_analytic
from repro_torch.train import optimizer as opt
from test_torch_model import KV_TOL, LOGIT_TOL, assert_close_bf16, \
    smoke_models
from torch_threads import one_torch_thread  # noqa: E402,F401

ARCHS = ["zamba2-7b", "rwkv6-1.6b"]
# fp32 recurrent states (SSM S) of O(1-10) from bf16 inputs: the
# products of an ulp-apart k and v sum over T steps; held relative to
# the state's largest value (measured: 0.4 % zamba2, 1.3 % rwkv6)
STATE_RTOL = 3e-2
# a greedy token may differ only at a near-tie of the reference's logits
NEAR_TIE = 2e-2


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return smoke_models(request.param)


def _np(t):
    return t.float().numpy()


def _bf16(a):
    """numpy fp32 -> (jax bf16, torch bf16) with equal values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _close_state(got, want):
    want = np.asarray(want, np.float32)
    got = _np(got)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=STATE_RTOL * scale)


def _close_cache(got, want, tol=KV_TOL):
    """One cache leaf: bf16 and int8 leaves per element, fp32 states
    relative to their largest value."""
    if got.dtype == torch.float32:
        _close_state(got, want)
    elif got.dtype == torch.int8:
        assert_close_bf16(got.numpy().astype(np.float32),
                          np.asarray(want, np.float32), 1.0, mean_tol=0.1)
    else:
        assert_close_bf16(_np(got), np.asarray(want, np.float32), tol)


def _leaves(caches):
    return [t for t in tuple(caches) if t is not None]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def test_init_params_tree_count_and_serving_copy(model):
    cfg, jparams, tcfg, _ = model
    mine = T.init_params(tcfg, seed=0, device="cpu")
    shapes = lambda tree: {jax.tree_util.keystr(p): tuple(v.shape) for p, v
                           in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(mine) == shapes(jparams)
    n = sum(t.numel() for t in opt.tree_leaves(mine))
    assert n == T.count_params(tcfg) == count_params_analytic(tcfg) \
        == jax_count(cfg)
    served = T.serving_params(mine)
    for key, leaf in jax.tree_util.tree_flatten_with_path(served)[0]:
        name = key[-1].key
        want = torch.bfloat16 if name in T._MATMUL_LEAVES else torch.float32
        assert leaf.dtype == want, jax.tree_util.keystr(key)
    cast = {k[-1].key for k, v in jax.tree_util.tree_flatten_with_path(
        served)[0] if v.dtype == torch.bfloat16}
    assert cast == ({"w_in", "w_out", "wq", "wk", "wv", "wo", "w_gate",
                     "w_up", "w_down"} if cfg.name.startswith("zamba2")
                    else {"w_r", "w_k", "w_v", "w_g", "w_o", "cm_wr",
                          "cm_wk", "cm_wv"})


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_sizes(arch):
    """The published configs' parameter counts (the reference's
    ``param_count``): zamba2-7b's 68 Mamba2 layers and one shared block,
    rwkv6-1.6b's 24 layers."""
    cfg = configs.get_config(arch)
    n = T.count_params(cfg)
    assert n == cfg.param_count()
    if arch == "zamba2-7b":
        R, P, rem = T._zamba2_shape(cfg)
        assert (R, P, rem) == (5, 13, 3)
        assert 5.5e9 < n < 5.9e9
    else:
        assert 1.4e9 < n < 2.2e9


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _layer(tree, *index):
    return jax.tree.map(lambda a: a[index], tree)


def test_mamba2_block_matches_reference():
    """zamba2's first Mamba2 layer on x (2, 20, d): the sequence forward
    from the zero state (the port's ``state=None``) and from a random
    state, then one decode step from each forward's state."""
    cfg, jparams, tcfg, tparams = smoke_models("zamba2-7b")
    jp = _layer(jparams["mamba_p"]["mamba"], 0, 0)
    tp = _layer(tparams["mamba_p"]["mamba"], 0, 0)
    rng = np.random.default_rng(0)
    jx, x = _bf16(rng.standard_normal((2, 20, cfg.d_model)))
    s, _, H, conv_ch = jax_mamba2._dims(cfg)
    jconv, conv = _bf16(rng.standard_normal((2, s.conv_kernel - 1,
                                             conv_ch)))
    S0 = rng.standard_normal((2, H, s.state_dim, s.head_dim)) \
        .astype(np.float32)
    states = [(jax_mamba2.init_mamba_state(cfg, 2), None),
              (jax_mamba2.MambaState(jconv, jnp.asarray(S0)),
               mamba2.MambaState(conv, torch.from_numpy(S0)))]
    jx1, x1 = _bf16(rng.standard_normal((2, 1, cfg.d_model)))
    for jst, st in states:
        with jax.disable_jit():
            jout, jst = jax_mamba2.mamba2_block_forward(jp, jx, cfg, jst)
            jdec, jst2 = jax_mamba2.mamba2_block_decode(jp, jx1, cfg, jst)
        out, st = mamba2.mamba2_block_forward(tp, x, tcfg, st)
        assert_close_bf16(_np(out), jout, KV_TOL)
        _close_cache(st.conv, jst.conv)
        _close_state(st.S, jst.S)
        dec, st2 = mamba2.mamba2_block_decode(tp, x1, tcfg, st)
        assert_close_bf16(_np(dec), jdec, KV_TOL)
        _close_cache(st2.conv, jst2.conv)
        _close_state(st2.S, jst2.S)


def test_rwkv6_block_matches_reference():
    """rwkv6's first layer on x (2, 20, d) from the zero state and from a
    random one, then one decode step from each forward's state."""
    cfg, jparams, tcfg, tparams = smoke_models("rwkv6-1.6b")
    jp = _layer(jparams["layers"]["block"], 0)
    tp = _layer(tparams["layers"]["block"], 0)
    rng = np.random.default_rng(1)
    d, H, N = cfg.d_model, cfg.n_heads, cfg.rwkv.head_dim
    jx, x = _bf16(rng.standard_normal((2, 20, d)))
    (jtm, tm), (jcm, cm) = (_bf16(rng.standard_normal((2, d)))
                            for _ in range(2))
    S0 = rng.standard_normal((2, H, N, N)).astype(np.float32)
    states = [(jax_rwkv6.init_rwkv_state(cfg, 2),
               rwkv6.init_rwkv_state(tcfg, 2)),
              (jax_rwkv6.RWKVState(jtm, jcm, jnp.asarray(S0)),
               rwkv6.RWKVState(tm, cm, torch.from_numpy(S0)))]
    jx1, x1 = _bf16(rng.standard_normal((2, 1, d)))
    for jst, st in states:
        with jax.disable_jit():
            jout, jst = jax_rwkv6.rwkv_block_forward(jp, jx, cfg, jst)
            jdec, jst2 = jax_rwkv6.rwkv_block_decode(jp, jx1, cfg, jst)
        out, st = rwkv6.rwkv_block_forward(tp, x, tcfg, st)
        assert_close_bf16(_np(out), jout, KV_TOL)
        for got, want in zip(st, jst):
            _close_cache(got, want)
        dec, st2 = rwkv6.rwkv_block_decode(tp, x1, tcfg, st)
        assert_close_bf16(_np(dec), jdec, KV_TOL)
        for got, want in zip(st2, jst2):
            _close_cache(got, want)


# ---------------------------------------------------------------------------
# the model: forward, loss, gradients, train step
# ---------------------------------------------------------------------------


PROMPTS = (2, 12)


@pytest.fixture(scope="module")
def reference_forward(model):
    """The reference's ``forward_seq`` (op by op) of 2 prompts of 12
    tokens: (tokens, logits, caches, aux).  Its prefill is the same
    forward unembedded at the last position only."""
    cfg, jparams, _, _ = model
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, PROMPTS)
    with jax.disable_jit():
        out = jax_T.forward_seq(jparams, cfg, jnp.asarray(toks))
    return (toks, *out)


def test_forward_seq_logits_and_caches_match_reference(model,
                                                       reference_forward):
    cfg, jparams, tcfg, tparams = model
    toks, jlogits, jcaches, jaux = reference_forward
    logits, caches, aux = T.forward_seq(tparams, tcfg,
                                        torch.from_numpy(toks))
    assert float(aux) == float(jaux) == 0.0
    assert_close_bf16(logits.numpy(), jlogits, LOGIT_TOL)
    got, want = _leaves(caches), jax.tree.leaves(jcaches)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close_cache(g, w)


# ---------------------------------------------------------------------------
# contiguous caches: init_caches, caches_from_prefill, serve_step
# ---------------------------------------------------------------------------


def _check_greedy(tok, jlogits, jtok):
    jl = np.asarray(jlogits, np.float32)
    tok = tok.numpy()
    gap = jl.max(-1) - jl[np.arange(len(tok)), tok]
    assert np.all((tok == np.asarray(jtok)) | (gap < NEAR_TIE)), gap


def _serve_both(model, jcaches, caches, token, pos0, steps: int = 2):
    """``steps`` serve_steps on both sides, each fed the reference's
    greedy tokens: logits, tokens (or near-ties) and every cache leaf."""
    cfg, jparams, tcfg, tparams = model
    jtoken = jnp.asarray(token, jnp.int32)
    ttoken = torch.from_numpy(np.asarray(token))
    for i in range(steps):
        with jax.disable_jit():
            jnext, jlogits, jcaches = jax_S.serve_step(
                jparams, jcaches, jtoken, jnp.int32(pos0 + i), cfg=cfg)
        before = [t.clone() for t in caches]
        nxt, logits, new = S.serve_step(tparams, caches, ttoken, pos0 + i,
                                        cfg=tcfg)
        assert all(torch.equal(a, b) for a, b in zip(before, caches))
        assert type(new) is type(caches)
        assert_close_bf16(logits.numpy(), jlogits, LOGIT_TOL)
        _check_greedy(nxt, jlogits, jnext)
        caches = new
        for got, want in zip(caches, jcaches):
            _close_cache(got, want)
        jtoken, ttoken = jnext, torch.from_numpy(np.array(jnext))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_serve_steps_from_init_caches_match_reference(model, kv):
    cfg, _, tcfg, _ = model
    kv_dtype = (jnp.int8, torch.int8) if kv == "int8" else (None, None)
    jcaches = jax_T.init_caches(cfg, 3, 16, kv_dtype=kv_dtype[0])
    caches = T.init_caches(tcfg, 3, 16, kv_dtype=kv_dtype[1], device="cpu")
    assert type(caches).__name__ == type(jcaches).__name__
    for got, want in zip(caches, jcaches):
        assert got.shape == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert not got.any()
    token = np.random.default_rng(3).integers(1, cfg.vocab_size, 3)
    _serve_both(model, jcaches, caches, token, 0)


def test_prefill_then_serve_steps_match_reference(model, reference_forward):
    """``prefill`` of 2 prompts of 12 tokens, ``caches_from_prefill`` to
    32 positions (attention K/V zero past the prompt; recurrent states
    whole), then 2 ``serve_step``s continuing from the prompts' end."""
    cfg, jparams, tcfg, tparams = model
    toks, jlogits, jraw, _ = reference_forward
    jlast = jlogits[:, -1]
    last, raw = S.prefill(tparams, tcfg, torch.from_numpy(toks))
    assert_close_bf16(last.numpy(), jlast, LOGIT_TOL)
    jcaches = jax_S.caches_from_prefill(cfg, jraw, 2, 32)
    caches = S.caches_from_prefill(tcfg, raw, 2, 32)
    assert type(caches) is type(T.init_caches(tcfg, 1, 1, device="cpu"))
    for got, want in zip(caches, jcaches):
        assert got.shape == want.shape
        _close_cache(got, want)
    if isinstance(caches, T.Zamba2Caches):
        for kv in (caches.attn_k, caches.attn_v):
            assert not kv[:, :, 12:].any()
    first = np.asarray(jnp.argmax(jlast, axis=-1))
    _check_greedy(torch.argmax(last, -1), jlast, first)
    _serve_both(model, jcaches, caches, first, 12)


# ---------------------------------------------------------------------------
# what is refused, and the launchers
# ---------------------------------------------------------------------------


def test_check_supported_names_only_what_is_missing():
    """Every arch of the registry passes (since the last three families
    were ported, MLA, a skip_first MoE, local_global and encoder-decoder
    models among them); a layer pattern the reference does not know
    either raises, naming it; the paged path takes uniform GQA decoders
    only, and refuses the SSM and hybrid families and the three others."""
    for arch in configs.list_archs():
        T.check_supported(configs.get_config(arch))
    for arch in ARCHS + ["gemma3-12b", "deepseek-v2-236b",
                         "whisper-large-v3"]:
        with pytest.raises(NotImplementedError, match="paged path"):
            check_paged(configs.get_smoke_config(arch))
    base = configs.get_smoke_config("qwen2-1.5b")
    moe = configs.get_smoke_config("olmoe-1b-7b")
    for ok in (dataclasses.replace(base, layer_pattern="local_global:1"),
               dataclasses.replace(base, mla=configs.MLAConfig()),
               dataclasses.replace(base, encoder_decoder=True),
               dataclasses.replace(moe, moe=dataclasses.replace(
                   moe.moe, layer_pattern="skip_first"))):
        T.check_supported(ok)
    with pytest.raises(NotImplementedError,
                       match="unknown layer pattern 'mixed'"):
        T.check_supported(dataclasses.replace(base, layer_pattern="mixed"))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_real_refuses_with_the_reference_message(arch, monkeypatch):
    """Real mode needs the paged path, which neither package has for
    these families: the port's launcher exits with the reference's
    message."""
    with pytest.raises(SystemExit) as want:
        jax_serve._build_real_bundle(arch, 0)
    monkeypatch.setattr(sys, "argv", ["serve", "--real", "--arch", arch,
                                      "--device", "cpu",
                                      "--conversations", "1"])
    with pytest.raises(SystemExit) as got:
        serve.main()
    assert str(got.value) == str(want.value)
    assert "real-mode serving needs a uniform GQA arch" in str(got.value)
