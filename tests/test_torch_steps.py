"""repro_torch's contiguous-cache step functions and their attention
pieces against the JAX package's (CPU, smoke configs, the reference's
weights converted with ``params_from_numpy``, the same numpy inputs):

  * ``_sdpa_chunked`` at a small ``chunk_q`` (with and without a window)
    against the port's ``_sdpa`` and the reference's ``_sdpa_chunked``,
    ``causal_mask``, and ``gqa_forward`` through its chunked branch;
  * ``gqa_decode`` with a window, as a ring buffer and over int8 caches,
    its inputs left unchanged;
  * ``serve_step`` over 3 steps from ``init_caches`` (bf16 and int8), and
    ``prefill`` -> ``caches_from_prefill`` -> ``serve_step`` continuing,
    for each of the five archs.

The reference runs op by op here (``jax.disable_jit``): jitted, XLA keeps
fused bf16 intermediates in fp32, which flips MoE routing near-ties
(tests/test_torch_moe_serving.py); op by op it rounds every bf16 op as
the port does.  Model outputs are held to tests/test_torch_model.py's
bf16 bounds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro.models import steps as jax_S
from repro.models import transformer as jax_T
from repro_torch import configs
from repro_torch.models import attention as attn
from repro_torch.models import steps as S
from repro_torch.models import transformer as T
from repro_torch.models.paged import supports_paged
from test_torch_model import KV_TOL, LOGIT_TOL, assert_close_bf16, \
    smoke_models
from torch_threads import one_torch_thread  # noqa: E402,F401

# the uniform GQA decoders; the SSM and hybrid families (zamba2, rwkv)
# are held in tests/test_torch_ssm.py and tests/test_torch_ssm_train.py,
# gemma3, deepseek-v2 (MLA) and whisper (encoder-decoder) in
# tests/test_torch_families.py and tests/test_torch_families_train.py
ARCHS = [a for a in configs.list_archs()
         if supports_paged(configs.get_config(a))]
# a greedy token may differ only where the reference's logits hold the
# port's token this close to their maximum (bf16 rounding can flip a
# near-tie, not a clear winner)
NEAR_TIE = 2e-2


def _bf16(a):
    """numpy fp32 -> (jax bf16, torch bf16) with equal values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return smoke_models(request.param)


def test_causal_mask_matches_reference():
    for T_, S_, window, offset in ((5, 5, None, 0), (4, 9, 3, 5),
                                   (7, 7, 2, 0)):
        np.testing.assert_array_equal(
            attn.causal_mask(T_, S_, window, offset).numpy(),
            np.asarray(jax_attn.causal_mask(T_, S_, window, offset)))


@pytest.mark.parametrize("window", [None, 5])
def test_sdpa_chunked_matches_sdpa_and_reference(window):
    """37 queries in chunks of 8 (the last padded): equal to one masked
    ``_sdpa`` over all of them, and to the reference's scan."""
    rng = np.random.default_rng(0)
    B, T_, Hq, Hkv, D = 2, 37, 4, 2, 16
    jq, q = _bf16(rng.standard_normal((B, T_, Hq, D)))
    jk, k = _bf16(rng.standard_normal((B, T_, Hkv, D)))
    jv, v = _bf16(rng.standard_normal((B, T_, Hkv, D)))
    scale = D ** -0.5
    got = attn._sdpa_chunked(q, k, v, scale, window=window, chunk_q=8)
    whole = attn._sdpa(q, k, v, attn.causal_mask(T_, T_, window), scale)
    np.testing.assert_array_equal(_np(got), _np(whole))
    with jax.disable_jit():
        want = jax_attn._sdpa_chunked(jq, jk, jv, scale, window=window,
                                      chunk_q=8)
    assert_close_bf16(_np(got), np.asarray(want, np.float32), 1e-2)


def test_gqa_forward_chunked_branch_matches_reference(monkeypatch):
    """Above ``CHUNK_THRESHOLD`` (lowered to 16 in both packages) the
    sequence goes through ``_sdpa_chunked``: output and K/V against the
    reference's."""
    cfg, jparams, tcfg, tparams = smoke_models("qwen2-1.5b")
    monkeypatch.setattr(attn, "CHUNK_THRESHOLD", 16)
    monkeypatch.setattr(jax_attn, "CHUNK_THRESHOLD", 16)
    calls = []
    real = attn._sdpa_chunked
    monkeypatch.setattr(attn, "_sdpa_chunked",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rng = np.random.default_rng(1)
    jx, x = _bf16(rng.standard_normal((2, 40, cfg.d_model)))
    pos = np.broadcast_to(np.arange(40), (2, 40))
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    lp = {k: v[0] for k, v in tparams["layers"]["attn"].items()}
    with jax.disable_jit():
        jout, (jk, jv) = jax_attn.gqa_forward(jlp, jx, cfg, jnp.asarray(pos))
    out, (k, v) = attn.gqa_forward(lp, x, tcfg, torch.from_numpy(pos))
    assert calls
    assert_close_bf16(_np(out), np.asarray(jout, np.float32), KV_TOL)
    assert_close_bf16(_np(k), np.asarray(jk, np.float32), KV_TOL)
    assert_close_bf16(_np(v), np.asarray(jv, np.float32), KV_TOL)


@pytest.mark.parametrize("case", [
    dict(S=12, pos=5), dict(S=12, pos=9, window=4),
    dict(S=8, pos=11, ring=True), dict(S=8, pos=3, ring=True),
    dict(S=12, pos=6, int8=True), dict(S=8, pos=13, ring=True, int8=True)],
    ids=["plain", "window", "ring_wrapped", "ring_filling", "int8",
         "int8_ring"])
def test_gqa_decode_matches_reference(case):
    """One token against (B, S, Hkv, D) caches of random contents: the
    output and both new caches against the reference's; the port's input
    caches keep their bytes."""
    cfg, jparams, tcfg, tparams = smoke_models("qwen2-1.5b")
    rng = np.random.default_rng(2)
    B, S_ = 3, case["S"]
    hd, Hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    jx, x = _bf16(rng.standard_normal((B, 1, cfg.d_model)))
    if case.get("int8"):
        c = rng.integers(-127, 128, (2, B, S_, Hkv, hd)).astype(np.int8)
        jck, jcv = jnp.asarray(c[0]), jnp.asarray(c[1])
        ck, cv = torch.from_numpy(c[0]), torch.from_numpy(c[1])
    else:
        c = rng.standard_normal((2, B, S_, Hkv, hd)) * 0.5
        (jck, ck), (jcv, cv) = _bf16(c[0]), _bf16(c[1])
    before = (ck.clone(), cv.clone())
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    lp = {k: v[0] for k, v in tparams["layers"]["attn"].items()}
    kw = dict(window=case.get("window"), ring=case.get("ring", False))
    with jax.disable_jit():
        jout, jk2, jv2 = jax_attn.gqa_decode(jlp, jx, cfg, jck, jcv,
                                             case["pos"], **kw)
    out, k2, v2 = attn.gqa_decode(lp, x, tcfg, ck, cv, case["pos"], **kw)
    assert torch.equal(ck, before[0]) and torch.equal(cv, before[1])
    assert k2.dtype == ck.dtype and k2.shape == ck.shape
    # the int8 caches dequantise to values up to 6.35, so outputs reach
    # ~10, and each side lies up to one bf16 ulp of the largest output
    # (0.0625) from a float64 evaluation: the bound is two such ulps
    # (the mean difference within a fifth of that)
    want = np.asarray(jout, np.float32)
    bound = max(KV_TOL, 2 * 2 ** -7 * float(np.abs(want).max()))
    assert_close_bf16(_np(out), want, bound, mean_tol=bound / 5)
    for got, want in ((k2, jk2), (v2, jv2)):
        got, want = _np(got).astype(np.float32), np.asarray(want, np.float32)
        # one int8 step where a value lies on a rounding boundary
        tol = 1.0 if case.get("int8") else KV_TOL
        assert_close_bf16(got, want, tol, mean_tol=tol / 10)
        slot = case["pos"] % S_ if case.get("ring") else case["pos"]
        untouched = np.arange(S_) != slot
        np.testing.assert_array_equal(got[:, untouched],
                                      want[:, untouched])


def _batch_inputs(cfg, rng, B, T_):
    toks = rng.integers(1, cfg.vocab_size, (B, T_))
    img = None
    if cfg.frontend is not None:
        img = (rng.standard_normal((B, cfg.frontend.n_tokens,
                                    cfg.frontend.d_embed)) * 0.5
               ).astype(np.float32)
    return toks, img


def _check_greedy(tok, jlogits, jtok):
    """The port's greedy tokens equal the reference's, or lie within
    ``NEAR_TIE`` of the reference's maximum."""
    jl = np.asarray(jlogits, np.float32)
    tok = tok.numpy()
    gap = jl.max(-1) - jl[np.arange(len(tok)), tok]
    assert np.all((tok == np.asarray(jtok)) | (gap < NEAR_TIE)), gap


def _serve_both(model, jcaches, caches, token, pos0, steps: int = 3):
    """``steps`` serve_steps on both sides, each side fed the reference's
    greedy tokens (so one near-tie cannot fork the two streams)."""
    cfg, jparams, tcfg, tparams = model
    jtoken = jnp.asarray(token, jnp.int32)
    ttoken = torch.from_numpy(np.asarray(token))
    for i in range(steps):
        with jax.disable_jit():
            jnext, jlogits, jcaches = jax_S.serve_step(
                jparams, jcaches, jtoken, jnp.int32(pos0 + i), cfg=cfg)
        nxt, logits, new = S.serve_step(tparams, caches, ttoken, pos0 + i,
                                        cfg=tcfg)
        assert logits.shape == (len(token), cfg.vocab_size)
        assert nxt.dtype == torch.int32
        assert_close_bf16(logits.numpy(), jlogits, LOGIT_TOL)
        _check_greedy(nxt, jlogits, jnext)
        assert not torch.equal(new.k, caches.k)        # a new cache
        caches = new
        for got, want in ((caches.k, jcaches.k), (caches.v, jcaches.v)):
            if got.dtype == torch.int8:
                assert_close_bf16(got.numpy().astype(np.float32),
                                  np.asarray(want, np.float32), 1.0,
                                  mean_tol=0.1)
            else:
                assert_close_bf16(_np(got), np.asarray(want, np.float32),
                                  KV_TOL)
        jtoken, ttoken = jnext, torch.from_numpy(np.asarray(jnext))
    return jcaches, caches


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_serve_steps_from_init_caches_match_reference(model, kv):
    cfg, _, tcfg, _ = model
    kv_dtype = (jnp.int8, torch.int8) if kv == "int8" else (None, None)
    jcaches = jax_T.init_caches(cfg, 3, 16, kv_dtype=kv_dtype[0])
    caches = T.init_caches(tcfg, 3, 16, kv_dtype=kv_dtype[1], device="cpu")
    assert isinstance(caches, T.KVCaches)
    assert caches.k.shape == jcaches.k.shape
    assert caches.k.dtype == (torch.int8 if kv == "int8"
                              else torch.bfloat16)
    token = np.random.default_rng(3).integers(1, cfg.vocab_size, 3)
    _serve_both(model, jcaches, caches, token, 0)


def test_prefill_then_serve_steps_match_reference(model):
    """``prefill`` of 2 prompts of 12 tokens (llava: behind 16 image
    embeddings), ``caches_from_prefill`` to 32 positions, then 3
    ``serve_step``s continuing from the prompts' end."""
    cfg, jparams, tcfg, tparams = model
    toks, img = _batch_inputs(cfg, np.random.default_rng(4), 2, 12)
    with jax.disable_jit():
        jlast, jraw = jax_S.prefill(
            jparams, cfg, jnp.asarray(toks),
            extra_embeds=None if img is None else jnp.asarray(img))
    last, raw = S.prefill(
        tparams, tcfg, torch.from_numpy(toks),
        extra_embeds=None if img is None else torch.from_numpy(img))
    assert_close_bf16(last.numpy(), jlast, LOGIT_TOL)
    n = raw[0].shape[2]
    assert n == 12 + (cfg.frontend.n_tokens if img is not None else 0)
    jcaches = jax_S.caches_from_prefill(cfg, jraw, 2, 32)
    caches = S.caches_from_prefill(tcfg, raw, 2, 32)
    assert caches.k.shape == jcaches.k.shape
    for got, want in ((caches.k, jcaches.k), (caches.v, jcaches.v)):
        assert_close_bf16(_np(got), np.asarray(want, np.float32), KV_TOL)
        assert not _np(got)[:, :, n:].any()
    first = np.asarray(jnp.argmax(jlast, axis=-1))
    _check_greedy(torch.argmax(last, -1), jlast, first)
    _serve_both(model, jcaches, caches, first, n)


def test_caches_from_prefill_refuses_other_families():
    """A layer pattern neither package knows is refused; the families
    refused before they were ported convert: qwen2's smoke config as
    one local_global period (a ring of its 8-token window) gives the
    reference's ``Gemma3Caches`` shapes and dtypes."""
    cfg = configs.get_smoke_config("qwen2-1.5b")
    with pytest.raises(NotImplementedError, match="unknown layer pattern"):
        S.caches_from_prefill(dataclasses.replace(cfg, layer_pattern="mixed"),
                              (None, None), 1, 8)
    gemma = dataclasses.replace(cfg, layer_pattern="local_global:1",
                                sliding_window=8)
    params = T.init_params(gemma, seed=0, device="cpu")
    _, raw = S.prefill(params, gemma, torch.ones((1, 12), dtype=torch.long))
    got = S.caches_from_prefill(gemma, raw, 1, 16)
    want = jax_T.init_caches(gemma, 1, 16)
    assert type(got).__name__ == type(want).__name__ == "Gemma3Caches"
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
    assert got.local_k.shape[3] == 8 and got.global_k.shape[2] == 16