"""repro_torch's last three model families against the JAX package's (CPU,
smoke configs, the reference's weights converted with
``params_from_numpy``, the same numpy inputs):

  * gemma3-12b's ``local_global`` pattern (one period of a sliding-window
    layer and a global one, window 64): the windowed attention, also
    through ``_sdpa_chunked``, and the local layers' ring caches, filled
    from a prompt longer than the window and decoded past a wrap;
  * deepseek-v2-236b's MLA (its sequence forward, also through
    ``_sdpa_chunked``, and the absorbed-weight decode) and its skip_first
    MoE (a dense layer 0, then a MoE layer with a shared expert), and
    olmoe's smoke config with a skip_first MoE (a dense GQA layer 0);
  * whisper-large-v3's encoder-decoder: LayerNorm, the tanh GELU MLP,
    cross attention, the encoder over frame embeddings, the decoder and
    its cross caches.
For each: the parameter tree and count, ``forward_seq`` logits and
caches, ``init_caches``, ``serve_step``s from zero caches (bf16 and int8
attention K/V) and ``prefill`` -> ``caches_from_prefill`` ->
``serve_step``s.  tests/test_torch_families_train.py holds the training
path.

The forward and the steps from zero caches hold the port to the
reference run op by op (``jax.disable_jit``), which rounds every bf16 op
as the port does (LayerNorm and GELU bit for bit); the rest to the
jitted reference, as tests/test_torch_model.py does (op by op each test
takes 10-25 s here, most of it per-op compiles).  Bounds are that
file's (logits 3e-2 per element and 5e-3 on the mean, bf16 caches 5e-2).
Jitted, XLA keeps fused bf16 intermediates in fp32: on these smoke
configs the reference's own forward, jitted against op by op, moves the
second layer's K by 5.1e-3 on the mean (gemma3) and the logits by up to
3.0e-3, where the port lies within 1.3e-4 and 1.3e-3 of op by op.  A MoE token
whose router holds its K-th and (K+1)-th experts within ``ROUTE_TIE`` in
probability may go to another expert on the two sides, which moves its
output by a whole expert's (deepseek's smoke forward has one such token,
a gap of 2.0e-4, its logits 0.90 apart); its logits are exempt, and
counted.  In the smoke config the MoE layer is the last, so no cache
depends on the routing.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import attention as jax_attn
from repro.models import layers as jax_L
from repro.models import steps as jax_S
from repro.models import transformer as jax_T
from repro.models.params import count_params_analytic as jax_count
from repro_torch import configs
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models import steps as S
from repro_torch.models import transformer as T
from repro_torch.models.params import count_params_analytic
from repro_torch.train import optimizer as opt
from test_torch_model import KV_TOL, LOGIT_TOL, MEAN_TOL, \
    assert_close_bf16, smoke_models
from torch_threads import one_torch_thread  # noqa: E402,F401

ARCHS = ["gemma3-12b", "deepseek-v2-236b", "whisper-large-v3"]
# a greedy token may differ only at a near-tie of the reference's logits
NEAR_TIE = 2e-2
# a router's K-th to (K+1)-th probability gap under which rounding may
# send a token to another expert (tests/test_torch_moe_serving.py's)
ROUTE_TIE = 1e-3
# int8 K/V (a step of KV_QSCALE = 0.05): a bf16 ulp of K, 0.0156 at |K|
# in [2, 4), is a third of a step, so an element an ulp apart rounds to
# the next step one time in three; after 12 steps gemma3's written rows
# differ by one step in ~14 % of their elements (mean 0.104 over the
# cache), where tests/test_torch_ssm.py's zamba2 cache stays under 0.1
INT8_MEAN_TOL = 0.2
# and such a step (0.05 in K) moves the logits more than an ulp does:
# whisper's int8 steps lie 5.1e-3 apart on the mean (logits of mean
# magnitude 0.56), its bf16 steps 1.3e-3; the int8 steps' mean bound is
# twice the bf16 one
INT8_LOGIT_MEAN_TOL = 1e-2


# the reference's init of a smoke config takes ~8 s (its per-leaf jits):
# once per arch in this module
smoke_models = functools.lru_cache(maxsize=None)(smoke_models)


@functools.lru_cache(maxsize=None)
def _skip_first_models():
    """``smoke_models`` of olmoe's smoke config with a skip_first MoE: a
    dense GQA layer 0 in front of the MoE layer, the uniform skip_first
    branch that no registry arch takes (deepseek's layer 0 is MLA)."""
    def skip_first(cfg):
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, layer_pattern="skip_first"))
    cfg = skip_first(jax_configs.get_smoke_config("olmoe-1b-7b"))
    jparams = jax_T.init_params(cfg, jax.random.PRNGKey(0))
    tparams = T.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    return (cfg, jparams,
            skip_first(configs.get_smoke_config("olmoe-1b-7b")), tparams)


@functools.lru_cache(maxsize=None)
def _ref(cfg):
    """The reference's ``prefill`` and ``serve_step`` for ``cfg``,
    jitted (one compile per shape)."""
    return {
        "prefill": jax.jit(lambda p, t, kw: jax_S.prefill(p, cfg, t, **kw)),
        "step": jax.jit(lambda p, c, t, pos: jax_S.serve_step(
            p, c, t, pos, cfg=cfg))}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return smoke_models(request.param)


def _np(t):
    return t.float().numpy()


def _bf16(a):
    """numpy fp32 -> (jax bf16, torch bf16) with equal values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _frames(cfg, B: int, seed: int = 4):
    """Encoder frame embeddings (B, S_enc, d) for an encoder-decoder, as
    (reference kwargs, port kwargs); empty for the others."""
    if not cfg.encoder_decoder:
        return {}, {}
    f = (np.random.default_rng(seed).standard_normal(
        (B, cfg.n_encoder_tokens, cfg.d_model)) * 0.5).astype(np.float32)
    return ({"encoder_frames": jnp.asarray(f)},
            {"encoder_frames": torch.from_numpy(f)})


@contextlib.contextmanager
def routing_gaps():
    """Within the block the port's MoE calls record, per call, each
    token's K-th to (K+1)-th router probability gap."""
    gaps, real = [], moe.route

    def route(router, xf, m):
        plan = real(router, xf, m)
        top = torch.sort(plan.probs, dim=-1, descending=True).values
        gaps.append(top[:, m.top_k - 1] - top[:, m.top_k])
        return plan
    moe.route = route
    try:
        yield gaps
    finally:
        moe.route = real


def _tied_rows(gaps, n_rows: int):
    """The rows (tokens of the call, flattened) whose routing in any MoE
    call of a forward over ``n_rows`` tokens had a near-tie."""
    tied = np.zeros(n_rows, bool)
    for g in gaps:
        tied |= g.numpy() < ROUTE_TIE
    return tied


def _close_logits(got, want, tied=None, mean_tol=MEAN_TOL) -> int:
    """Logits (..., V) per element and on the mean, rows routed at a
    near-tie exempt; returns how many were."""
    got, want = got.reshape(-1, got.shape[-1]), np.asarray(
        want, np.float32).reshape(-1, got.shape[-1])
    keep = np.ones(len(got), bool) if tied is None else ~tied
    if keep.any():
        assert_close_bf16(got.numpy()[keep], want[keep], LOGIT_TOL,
                          mean_tol)
    return int((~keep).sum())


def _close_cache(got, want):
    """A cache leaf: bf16 per element and on the mean; int8 within one
    quantisation step per element, and on the mean within INT8_MEAN_TOL."""
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    if got.dtype == torch.int8:
        assert_close_bf16(got.numpy().astype(np.float32), want, 1.0,
                          mean_tol=INT8_MEAN_TOL)
    else:
        assert_close_bf16(_np(got), want, KV_TOL)


# ---------------------------------------------------------------------------
# parameters and layers
# ---------------------------------------------------------------------------


def test_init_params_tree_count_and_serving_copy(model):
    """The reference's tree key for key (whisper's unused ``lm_head`` and
    ``final_norm`` too), the count of every arch's smoke config; the
    serving init equals ``serving_params`` of the fp32 init leaf for leaf,
    its matmul leaves bf16 and its norms fp32."""
    cfg, jparams, tcfg, _ = model
    mine = T.init_params(tcfg, seed=0, device="cpu")
    shapes = lambda tree: {jax.tree_util.keystr(p): tuple(v.shape) for p, v
                           in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(mine) == shapes(jparams)
    n = sum(t.numel() for t in opt.tree_leaves(mine))
    assert n == T.count_params(tcfg) == count_params_analytic(tcfg) \
        == jax_count(cfg)
    assert count_params_analytic(tcfg, True) == jax_count(cfg, True)
    served = T.init_params(tcfg, seed=0, device="cpu", serving=True)
    want = T.serving_params(mine)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(opt.tree_leaves(served))
    for path, w in flat:
        got = served
        for k in path:
            got = got[k.key]
        assert got.dtype == w.dtype and torch.equal(got, w), path
    dtypes = {jax.tree_util.keystr(p): v.dtype for p, v in
              jax.tree_util.tree_flatten_with_path(served)[0]}
    assert any(d == torch.bfloat16 for d in dtypes.values())
    for k, d in dtypes.items():
        if "norm" in k or "'ln" in k or "router" in k or "embed" in k:
            assert d == torch.float32, k


@pytest.mark.parametrize("arch", [a for a in configs.list_archs()
                                  if a not in ARCHS])
def test_serving_init_equals_the_serving_copy(arch):
    """The serve launcher and chip_smoke draw their serving weights with
    ``init_params(serving=True)``: for the registry's other archs too it
    equals ``serving_params`` of the fp32 init, leaf for leaf and dtype
    for dtype."""
    cfg = configs.get_smoke_config(arch)
    served = T.init_params(cfg, seed=3, device="cpu", serving=True)
    want = T.serving_params(T.init_params(cfg, seed=3, device="cpu"))
    got_flat, want_flat = opt.tree_leaves(served), opt.tree_leaves(want)
    assert len(got_flat) == len(want_flat)
    assert any(w.dtype == torch.bfloat16 for w in want_flat)
    for got, w in zip(got_flat, want_flat):
        assert got.dtype == w.dtype and torch.equal(got, w)


def test_layernorm_and_gelu_mlp_match_reference():
    """In bf16: LayerNorm (population variance) and the GELU MLP (the
    tanh form, rounded op by op as ``jax.nn.gelu`` rounds): bit-equal to
    the reference run op by op, but for a bf16 product rounded from fp32
    sums in another order (one ulp, rare); ``F.gelu``'s erf form would
    miss the bound."""
    rng = np.random.default_rng(1)
    d, f = 64, 96
    jx, tx = _bf16(rng.standard_normal((3, 7, d)) * 2)
    ln = {"scale": rng.standard_normal(d).astype(np.float32),
          "bias": rng.standard_normal(d).astype(np.float32)}
    mlp = {"w_in": (rng.standard_normal((d, f)) / 8).astype(np.float32),
           "b_in": rng.standard_normal(f).astype(np.float32),
           "w_out": (rng.standard_normal((f, d)) / 10).astype(np.float32),
           "b_out": rng.standard_normal(d).astype(np.float32)}
    j = lambda p: {k: jnp.asarray(v) for k, v in p.items()}
    t = lambda p: {k: torch.from_numpy(v) for k, v in p.items()}
    with jax.disable_jit():
        jln = np.asarray(jax_L.layernorm(j(ln), jx, 1e-5), np.float32)
        jmlp = np.asarray(jax_L.gelu_mlp(j(mlp), jx), np.float32)
        jg = np.asarray(jax.nn.gelu(jx), np.float32)
    np.testing.assert_array_equal(_np(L.layernorm(t(ln), tx, 1e-5)), jln)
    np.testing.assert_array_equal(_np(L.gelu(tx)), jg)
    got = _np(L.gelu_mlp(t(mlp), tx))
    assert_close_bf16(got, jmlp, 2 ** -7 * float(np.abs(jmlp).max()),
                      mean_tol=1e-3)
    assert float(np.mean(got == jmlp)) > 0.98
    erf = _np(torch.nn.functional.gelu(tx))
    assert float(np.mean(erf == jg)) < 0.9
    # the init: LayerNorm unit scale, zero bias; MLP biases zero
    p = L.init_gelu_mlp(torch.Generator().manual_seed(0), d, f)
    assert not p["b_in"].any() and not p["b_out"].any()
    assert abs(float(p["w_in"].std()) * d ** 0.5 - 1.0) < 0.05


def test_cross_attention_matches_reference():
    """whisper's cross attention on the smoke config's widths: the
    encoder's K/V projections and the unmasked attention of 5 queries
    over 32 frames."""
    cfg, jparams, tcfg, tparams = smoke_models("whisper-large-v3")
    jp = jax.tree.map(lambda a: a[0], jparams["dec_layers"]["cross_attn"])
    tp = {k: v[0] for k, v in tparams["dec_layers"]["cross_attn"].items()}
    rng = np.random.default_rng(2)
    jenc, tenc = _bf16(rng.standard_normal((2, 32, cfg.d_model)))
    jx, tx = _bf16(rng.standard_normal((2, 5, cfg.d_model)))
    jkv = jax.jit(lambda e: jax_attn.project_cross_kv(jp, e, cfg))(jenc)
    jout = jax.jit(lambda x, kv: jax_attn.cross_attention(jp, x, kv, cfg))(
        jx, jkv)
    kv = attn.project_cross_kv(tp, tenc, tcfg)
    for got, want in zip(kv, jkv):
        _close_cache(got, want)
    assert_close_bf16(_np(attn.cross_attention(tp, tx, kv, tcfg)),
                      np.asarray(jout, np.float32), KV_TOL)


@contextlib.contextmanager
def _chunked(on: bool):
    """Both packages' sequence attention through ``_sdpa_chunked`` (chunks
    of 1024 queries) from T > 16 on, when ``on``."""
    saved = attn.CHUNK_THRESHOLD, jax_attn.CHUNK_THRESHOLD
    if on:
        attn.CHUNK_THRESHOLD = jax_attn.CHUNK_THRESHOLD = 16
    try:
        yield
    finally:
        attn.CHUNK_THRESHOLD, jax_attn.CHUNK_THRESHOLD = saved


@pytest.mark.parametrize("chunked", [False, True])
def test_mla_forward_matches_reference(chunked):
    """MLA's sequence forward (V padded to the q/k head dim, the RoPE key
    shared by every head) on deepseek's smoke layer 0, over 24 tokens;
    with ``chunked`` through ``_sdpa_chunked`` (above CHUNK_THRESHOLD):
    the output and the cache (latent, k_rope)."""
    cfg, jparams, tcfg, tparams = smoke_models("deepseek-v2-236b")
    rng = np.random.default_rng(3)
    jx, tx = _bf16(rng.standard_normal((2, 24, cfg.d_model)))
    pos = np.broadcast_to(np.arange(24), (2, 24))
    with _chunked(chunked):
        jout, jc = jax.jit(lambda x, q: jax_attn.mla_forward(
            jparams["layer0"]["attn"], x, cfg, q))(jx, jnp.asarray(pos))
    with _chunked(chunked):
        out, c = attn.mla_forward(tparams["layer0"]["attn"], tx, tcfg,
                                  torch.from_numpy(pos.copy()))
    assert_close_bf16(_np(out), np.asarray(jout, np.float32), KV_TOL)
    for got, want in zip(c, jc):
        _close_cache(got, want)


def test_mla_decode_matches_reference():
    """The absorbed-weight decode of one token at position 9 against a
    cache of 16 positions (random latents and RoPE keys, the tail past
    the position masked): the output and the cache with row 9 written,
    the rest unchanged; and it agrees with the sequence forward's last
    position over the same 10 tokens (the absorption is exact algebra,
    only the roundings differ)."""
    cfg, jparams, tcfg, tparams = smoke_models("deepseek-v2-236b")
    m = cfg.mla
    rng = np.random.default_rng(4)
    jlat, lat = _bf16(rng.standard_normal((2, 16, m.kv_lora_rank)))
    jkr, kr = _bf16(rng.standard_normal((2, 16, m.rope_head_dim)))
    jx, tx = _bf16(rng.standard_normal((2, 1, cfg.d_model)))
    jp, tp = jparams["layer0"]["attn"], tparams["layer0"]["attn"]
    jout, jc = jax.jit(lambda x, c: jax_attn.mla_decode(jp, x, cfg, c, 9))(
        jx, jax_attn.MLACache(jlat, jkr))
    cache = attn.MLACache(lat, kr)
    out, c = attn.mla_decode(tp, tx, tcfg, cache, 9)
    assert torch.equal(cache.latent, lat)
    assert_close_bf16(_np(out), np.asarray(jout, np.float32), KV_TOL)
    for got, want, old in zip(c, jc, (lat, kr)):
        _close_cache(got, want)
        assert torch.equal(torch.cat([got[:, :9], got[:, 10:]], 1),
                           torch.cat([old[:, :9], old[:, 10:]], 1))
    # against the sequence forward over 10 tokens
    jxs, txs = _bf16(rng.standard_normal((2, 10, cfg.d_model)))
    seq, sc = attn.mla_forward(tp, txs, tcfg, torch.arange(10)[None].expand(
        2, 10))
    cache = attn.MLACache(torch.cat([sc.latent[:, :9], lat[:, 9:]], 1),
                          torch.cat([sc.k_rope[:, :9], kr[:, 9:]], 1))
    dec, _ = attn.mla_decode(tp, txs[:, 9:], tcfg, cache, 9)
    ref = _np(seq[:, 9:])
    assert float(np.abs(_np(dec) - ref).max()) <= 4 * 2 ** -8 * float(
        np.abs(ref).max())


def test_windowed_attention_matches_reference_through_the_chunks():
    """gemma3's local layer: ``gqa_forward`` over 80 tokens with its
    window of 64, through ``_sdpa_chunked`` (threshold lowered) and
    through ``_sdpa``, against the reference's; the two routes agree."""
    cfg, jparams, tcfg, tparams = smoke_models("gemma3-12b")
    jp = jax.tree.map(lambda a: a[0, 0], jparams["periods"]["local"]["attn"])
    tp = {k: v[0, 0] for k, v in tparams["periods"]["local"]["attn"].items()}
    rng = np.random.default_rng(5)
    jx, tx = _bf16(rng.standard_normal((1, 80, cfg.d_model)))
    pos = np.arange(80)[None]
    outs = []
    for chunked in (False, True):
        with _chunked(chunked):
            jout, _ = jax.jit(lambda x, q: jax_attn.gqa_forward(
                jp, x, cfg, q, window=cfg.sliding_window))(jx,
                                                           jnp.asarray(pos))
        with _chunked(chunked):
            out, _ = attn.gqa_forward(tp, tx, tcfg, torch.from_numpy(pos),
                                      window=tcfg.sliding_window)
        assert_close_bf16(_np(out), np.asarray(jout, np.float32), KV_TOL)
        outs.append(_np(out))
    assert_close_bf16(outs[0], outs[1], KV_TOL)


# ---------------------------------------------------------------------------
# the model: forward, caches, decode
# ---------------------------------------------------------------------------


def _forward_both(model, toks):
    cfg, jparams, tcfg, tparams = model
    jkw, tkw = _frames(cfg, toks.shape[0])
    with jax.disable_jit():
        jlogits, jcaches, jaux = jax_T.forward_seq(
            jparams, cfg, jnp.asarray(toks), **jkw)
    with routing_gaps() as gaps:
        logits, caches, aux = T.forward_seq(
            tparams, tcfg, torch.from_numpy(toks), **tkw)
    return (jlogits, jcaches, jaux), (logits, caches, aux), \
        _tied_rows(gaps, toks.size)


def _flat_caches(caches):
    """A forward's caches as a list of tensors (skip_first's dict
    flattened first, then rest)."""
    if isinstance(caches, dict):
        return list(caches["first"]) + list(caches["rest"])
    return [t for t in caches if t is not None]


def test_forward_seq_logits_and_caches_match_reference(model):
    """``forward_seq`` over 2 x 24 tokens (gemma3: 2 x 72, past its window
    of 64; whisper: against 32 frames): logits (tokens routed at a
    near-tie exempt, at most one in eight), the caches leaf for leaf
    (skip_first's {"first", "rest"}, gemma3's per-layer local and global
    K/V, whisper's self and cross K/V), and the MoE aux loss."""
    cfg = model[0]
    T_ = 72 if cfg.sliding_window else 24
    toks = np.random.default_rng(6).integers(1, cfg.vocab_size, (2, T_))
    (jl, jc, jaux), (tl, tc, taux), tied = _forward_both(model, toks)
    assert _close_logits(tl, jl, tied) <= toks.size // 8
    assert type(tc).__name__ == type(jc).__name__
    if isinstance(jc, dict):
        assert set(tc) == {"first", "rest"}
        assert isinstance(tc["first"], attn.MLACache)
    got, want = _flat_caches(tc), _flat_caches(jc)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close_cache(g, w)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-3)
    if cfg.moe is not None:
        assert float(taux) > 0


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_serve_steps_from_init_caches_match_reference(model, kv):
    """``init_caches`` (types, shapes, dtypes: gemma3's rings of
    min(window, cache_len) slots, MLA's latents ignoring the int8
    request, whisper's cross K/V in bf16), then 6 ``serve_step``s from
    position 0 on the same tokens, whisper's cross K/V taken from its
    prefill: logits (rows routed at a near-tie exempt, at most a quarter
    of them), and every cache leaf at the end (the rings' wrap is held by
    the prefill test below)."""
    cfg, jparams, tcfg, tparams = model
    kv_dtype = (jnp.int8, torch.int8) if kv == "int8" else (None, None)
    jcaches = jax_T.init_caches(cfg, 2, 8, kv_dtype=kv_dtype[0])
    caches = T.init_caches(tcfg, 2, 8, kv_dtype=kv_dtype[1], device="cpu")
    assert type(caches).__name__ == type(jcaches).__name__
    for got, want in zip(caches, jcaches):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert not got.any()
    if cfg.encoder_decoder:
        jkw, tkw = _frames(cfg, 2)
        _, jraw = _ref(cfg)["prefill"](jparams, jnp.ones((2, 1), jnp.int32),
                                       jkw)
        _, raw = S.prefill(tparams, tcfg, torch.ones((2, 1), dtype=torch.long),
                           **tkw)
        jcaches = jcaches._replace(cross_k=jraw[2], cross_v=jraw[3])
        caches = caches._replace(cross_k=raw[2], cross_v=raw[3])
    toks = np.random.default_rng(7).integers(1, cfg.vocab_size, (6, 2))
    tied = 0
    for i in range(6):
        with jax.disable_jit():
            _, jlogits, jcaches = jax_S.serve_step(
                jparams, jcaches, jnp.asarray(toks[i]), jnp.int32(i),
                cfg=cfg)
        with routing_gaps() as gaps:
            _, logits, caches = S.serve_step(
                tparams, caches, torch.from_numpy(toks[i]), i, cfg=tcfg)
        tied += _close_logits(
            logits, jlogits, _tied_rows(gaps, 2),
            INT8_LOGIT_MEAN_TOL if kv == "int8" else MEAN_TOL)
    assert tied <= 3
    for got, want in zip(caches, jcaches):
        _close_cache(got, want)


def _check_greedy(tok, jlogits, jtok):
    jl = np.asarray(jlogits, np.float32)
    tok = tok.numpy()
    gap = jl.max(-1) - jl[np.arange(len(tok)), tok]
    assert np.all((tok == np.asarray(jtok)) | (gap < NEAR_TIE)), gap


# (arch, prompt length, decode steps, cache length): gemma3 from a prompt
# shorter than its window of 64 whose decode fills the ring and wraps its
# slots (positions 60..65: slot 63, then 0), and from one longer than the
# window (70: the ring holds positions 6..69 rolled by 6) whose decode
# overwrites the oldest slots
DECODES = [("gemma3-12b", 60, 6, 72), ("gemma3-12b", 70, 6, 80),
           ("deepseek-v2-236b", 16, 6, 24), ("whisper-large-v3", 16, 6, 24)]


@pytest.mark.parametrize("arch,plen,steps,cache_len", DECODES,
                         ids=[f"{a}-p{p}" for a, p, _, _ in DECODES])
def test_prefill_then_serve_steps_match_reference(arch, plen, steps,
                                                  cache_len):
    """``prefill`` (last logits) -> ``caches_from_prefill`` (every leaf,
    the ring roll included) -> greedy ``serve_step``s fed the reference's
    tokens: logits, tokens equal or near-ties, every cache leaf after each
    step (rows routed at a near-tie exempt, at most a quarter of them);
    the inputs are left unchanged."""
    cfg, jparams, tcfg, tparams = smoke_models(arch)
    toks = np.random.default_rng(8).integers(1, cfg.vocab_size, (2, plen))
    jkw, tkw = _frames(cfg, 2)
    jlast, jraw = _ref(cfg)["prefill"](jparams, jnp.asarray(toks), jkw)
    jcaches = jax_S.caches_from_prefill(cfg, jraw, 2, cache_len)
    with routing_gaps() as gaps:
        last, raw = S.prefill(tparams, tcfg, torch.from_numpy(toks), **tkw)
    # the prefill's last positions: the MoE's rows are its 2 x plen tokens
    tied = _tied_rows(gaps, 2 * plen).reshape(2, plen)[:, -1]
    n_tied = _close_logits(last, jlast, tied)
    caches = S.caches_from_prefill(tcfg, raw, 2, cache_len)
    assert type(caches).__name__ == type(jcaches).__name__
    for got, want in zip(caches, jcaches):
        _close_cache(got, want)
    jtok = jnp.argmax(jlast, axis=-1).astype(jnp.int32)
    for i in range(steps):
        jnext, jlogits, jcaches = _ref(cfg)["step"](jparams, jcaches, jtok,
                                                    jnp.int32(plen + i))
        before = [t.clone() for t in caches]
        with routing_gaps() as gaps:
            nxt, logits, new = S.serve_step(
                tparams, caches, torch.from_numpy(np.array(jtok)), plen + i,
                cfg=tcfg)
        assert all(torch.equal(a, b) for a, b in zip(before, caches))
        tied = _tied_rows(gaps, 2)
        n_tied += _close_logits(logits, jlogits, tied)
        _check_greedy(nxt[~torch.from_numpy(tied)],
                      np.asarray(jlogits)[~tied], np.asarray(jnext)[~tied])
        caches = new
        for got, want in zip(caches, jcaches):
            _close_cache(got, want)
        jtok = jnext
    assert n_tied <= 2 * (steps + 1) // 4


def test_skip_first_gqa_prefill_caches_and_steps():
    """olmoe's smoke config with a skip_first MoE: ``prefill`` and
    ``caches_from_prefill`` (layer 0's K/V put in front of the others')
    against the reference's.  The reference's ``decode_step`` does not
    run this config (it scans ``layers`` against all L caches), so each
    greedy ``serve_step``'s logits are held to the reference's
    ``forward_seq`` over the history at its last position, and the
    caches' written rows to that forward's caches."""
    cfg, jparams, tcfg, tparams = _skip_first_models()
    plen, steps, cache_len = 16, 6, 24
    toks = np.random.default_rng(8).integers(1, cfg.vocab_size, (2, plen))
    jlast, jraw = _ref(cfg)["prefill"](jparams, jnp.asarray(toks), {})
    jcaches = jax_S.caches_from_prefill(cfg, jraw, 2, cache_len)
    with routing_gaps() as gaps:
        last, raw = S.prefill(tparams, tcfg, torch.from_numpy(toks))
    tied = _tied_rows(gaps, 2 * plen).reshape(2, plen)[:, -1]
    n_tied = _close_logits(last, jlast, tied)
    caches = S.caches_from_prefill(tcfg, raw, 2, cache_len)
    assert type(caches).__name__ == type(jcaches).__name__
    for got, want in zip(caches, jcaches):
        _close_cache(got, want)
    forward = jax.jit(lambda p, t: jax_T.forward_seq(p, cfg, t)[:2])
    hist, tok = toks, torch.argmax(last, -1)
    for i in range(steps):
        hist = np.concatenate([hist, tok.numpy()[:, None]], 1)
        jlogits, jseq = forward(jparams, jnp.asarray(hist))
        jlogits = np.asarray(jlogits, np.float32)[:, -1]
        with routing_gaps() as gaps:
            nxt, logits, caches = S.serve_step(tparams, caches, tok,
                                               plen + i, cfg=tcfg)
        tied = _tied_rows(gaps, 2)
        n_tied += _close_logits(logits, jlogits, tied)
        _check_greedy(nxt[~torch.from_numpy(tied)], jlogits[~tied],
                      jlogits[~tied].argmax(-1))
        tok = nxt
    n = hist.shape[1]
    for got, first, rest in zip(caches, jseq["first"], jseq["rest"]):
        want = np.concatenate([np.asarray(first, np.float32)[None],
                               np.asarray(rest, np.float32)])
        _close_cache(got[:, :, :n], want)
    assert n_tied <= 2 * (steps + 1) // 4


def test_ring_slots_hold_their_positions():
    """gemma3's local rings after ``caches_from_prefill``: from a prompt
    of T >= W positions slot s holds the K of the position p in the last
    W with p % W == s (a roll off by one fails); from a shorter prompt
    slots 0..T-1 hold positions 0..T-1 and the rest is zero."""
    _, _, tcfg, tparams = smoke_models("gemma3-12b")
    W = tcfg.sliding_window
    for plen in (W + 37, W - 9):
        toks = torch.from_numpy(np.random.default_rng(plen).integers(
            1, tcfg.vocab_size, (1, plen)))
        _, raw = S.prefill(tparams, tcfg, toks)
        ring = S.caches_from_prefill(tcfg, raw, 1, 2 * W).local_k
        k = raw[0]                                      # (P, R, B, T, H, D)
        assert ring.shape[3] == W
        for p in range(max(0, plen - W), plen):
            assert torch.equal(ring[:, :, :, p % W], k[:, :, :, p]), p
        if plen < W:
            assert not ring[:, :, :, plen:].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_real_refuses_with_the_reference_message(arch, monkeypatch):
    """Real mode needs the paged path, which neither package has for
    these families (``supports_paged``: uniform GQA decoders only): the
    port's launcher exits with the reference's message."""
    import sys

    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as want:
        jax_serve._build_real_bundle(arch, 0)
    monkeypatch.setattr(sys, "argv", ["serve", "--real", "--arch", arch,
                                      "--device", "cpu",
                                      "--conversations", "1"])
    with pytest.raises(SystemExit) as got:
        serve.main()
    assert str(got.value) == str(want.value) == (
        f"{arch}: real-mode serving needs a uniform GQA arch (paged pool "
        "path); use sim mode for this family")


# tests/test_arch_smoke.py's ranges (billions of parameters)
FULL_RANGES = {"mistral-nemo-12b": (11, 14), "qwen2-1.5b": (1.2, 2.0),
               "llama3.2-3b": (3.0, 4.0), "gemma3-12b": (10, 14),
               "olmoe-1b-7b": (6, 8), "deepseek-v2-236b": (200, 260),
               "rwkv6-1.6b": (1.4, 2.2), "zamba2-7b": (5, 12),
               "llava-next-mistral-7b": (6.5, 8),
               "whisper-large-v3": (1.2, 2.0)}


@pytest.mark.parametrize("arch", sorted(FULL_RANGES))
def test_full_config_counts_match_reference(arch):
    """``count_params`` of every full config, from shapes alone, equals
    the reference's ``count_params_analytic`` (``jax.eval_shape`` of its
    init) and lies in tests/test_arch_smoke.py's range; the active count
    too (deepseek's skip_first layer 0 holds no routed experts)."""
    from repro import configs as jax_configs
    from repro_torch import configs
    want, got = jax_configs.get_config(arch), configs.get_config(arch)
    assert T.count_params(got) == jax_count(want)
    assert count_params_analytic(got, True) == jax_count(want, True)
    lo, hi = FULL_RANGES[arch]
    assert lo <= T.count_params(got) / 1e9 <= hi
