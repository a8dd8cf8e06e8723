"""Parameters, the plain sequence forward and the contiguous-cache decode
step of every layer pattern the reference runs.

Counterpart of ``repro/models/transformer.py`` (``init_params``,
``forward_seq``, the cache tuples, ``init_caches``, ``decode_step``) for:
  * the uniform pattern with GQA attention and a dense or MoE FFN
    (qwen2-1.5b, llama3.2-3b, mistral-nemo-12b, olmoe-1b-7b, and
    llava-next-mistral-7b's language model behind its vision stub), and
    with MLA attention and a skip_first MoE (deepseek-v2-236b: a dense
    layer 0, then MoE layers with shared experts);
  * gemma3 (``local_global:R``, gemma3-12b): periods of R sliding-window
    layers, whose decode caches are rings of W = window slots, and one
    global layer;
  * zamba2 (zamba2-7b): periods of ``hybrid_attn_every - 1`` Mamba2
    layers and one attention block whose parameters are SHARED by every
    period, then a remainder of Mamba2 layers;
  * rwkv (rwkv6-1.6b): RWKV6 blocks in every layer;
  * whisper (whisper-large-v3): a bidirectional LayerNorm/GELU encoder
    over precomputed frame embeddings (the audio frontend is a stub, as
    in the reference) and a decoder of self attention, cross attention
    and a GELU MLP; its logits use the embedding table.
Parameters keep the reference's STACKED layout — every per-layer leaf
carries the leading axes ``_stack_init`` gives it — so
``params_from_numpy`` converts the reference's parameters leaf by leaf:

    {"embed": {"table"}, "final_norm": {"scale"}, ["lm_head": {"table"}],
     uniform: "layers": {"ln1": {"scale"}, "ln2": {"scale"},
                "attn": {"wq", "wk", "wv", "wo", ["bq", "bk", "bv"]}
                     or {"w_dq", "w_uq", "w_dkv", "w_krope", "w_uk",
                         "w_uv", "wo", "q_norm", "kv_norm"}  (MLA),
                "ffn": {"w_gate", "w_up", "w_down"}      (dense)
                    or {"router", "w_gate", "w_up", "w_down",
                        ["shared": {"w_gate", "w_up", "w_down"}]}  (MoE)},
              ["layer0": one dense layer, unstacked  (skip_first)],
              ["mm_proj": {"w"}];
     gemma3:  "periods": {"local": a layer (P, R, ...),
                          "global": a layer (P, ...)};
     zamba2:  "mamba_p": {"ln": {"scale"}, "mamba": {...}}  (P, R, ...),
              ["mamba_rem": the same, (rem, ...)],
              "attn_shared": {"ln1", "ln2", "attn", "ffn"}  (one block);
     rwkv:    "layers": {"ln1": {"scale"}, "block": {...}}  (L, ...);
     whisper: "enc_layers": {"ln1", "attn", "ln2", "mlp"}  (L_enc, ...),
              "enc_norm": {"scale", "bias"},
              "dec_layers": {"ln1", "self_attn", "ln2", "cross_attn",
                             "ln3", "mlp"}  (L, ...)}
(LayerNorms hold {"scale", "bias"}, GELU MLPs {"w_in", "b_in", "w_out",
"b_out"}; whisper keeps the reference's unused ``final_norm`` and
``lm_head`` leaves, and trains its CE against ``lm_head`` as the
reference's ``lm_loss`` does.)
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba2, moe, rwkv6
from repro_torch.models.attention import MLACache
from repro_torch.models.sharding import constrain_batch

# leaves of the layer stacks that are matrix-product weights or biases
# (cast at use by every layer); norm scales and biases stay fp32 (the
# reference multiplies fp32 activations by them), and so do a MoE router
# (the reference routes in fp32) and the SSM blocks' decays, A_log,
# dt_bias, u_bonus, mixes and LoRA factors
_MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv",
                  "w_dq", "w_uq", "w_dkv", "w_krope", "w_uk", "w_uv",  # MLA
                  "w_gate", "w_up", "w_down",
                  "w_in", "w_out", "b_in", "b_out",   # mamba2, GELU MLP
                  "w_r", "w_k", "w_v", "w_g", "w_o",       # rwkv6 time mix
                  "cm_wr", "cm_wk", "cm_wv")               # rwkv6 channel mix
# the parameter stacks, by layer pattern
_STACKS = ("layers", "layer0", "periods", "mamba_p", "mamba_rem",
           "attn_shared", "enc_layers", "enc_norm", "dec_layers")
# the layer patterns the reference's ``init_params`` knows
_PATTERNS = ("uniform", "gemma3", "zamba2", "rwkv")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a layer pattern the reference
    does not know either (its ``init_params`` raises ``ValueError``
    there).  Every config of the registry passes.  A vision frontend is a
    stub whose embeddings ``forward_seq`` takes as ``extra_embeds``
    (serving ignores it, as the reference's does); an audio frontend is
    whisper's, whose encoder takes ``encoder_frames``."""
    if _pattern(cfg) not in _PATTERNS:
        raise NotImplementedError(
            f"{cfg.name}: unknown layer pattern {cfg.layer_pattern!r}; the "
            f"port runs {', '.join(_PATTERNS)} and encoder-decoder models, "
            "as the reference does")


def _pattern(cfg: ModelConfig) -> str:
    lp = cfg.layer_pattern
    return "gemma3" if lp.startswith("local_global") else lp


def _gemma3_shape(cfg: ModelConfig):
    """(local layers per period R, periods P)."""
    R = int(cfg.layer_pattern.split(":")[1])
    if cfg.n_layers % (R + 1):
        raise ValueError(f"{cfg.name}: the gemma3 pattern needs n_layers % "
                         f"{R + 1} == 0, got {cfg.n_layers}")
    return R, cfg.n_layers // (R + 1)


def _skip_first(cfg: ModelConfig) -> bool:
    """deepseek-v2: layer 0 dense, the MoE FFN from layer 1 on."""
    return cfg.moe is not None and cfg.moe.layer_pattern == "skip_first"


def _zamba2_shape(cfg: ModelConfig):
    """(Mamba2 layers per period R, periods P, remainder layers)."""
    every = cfg.hybrid_attn_every
    return every - 1, cfg.n_layers // every, cfg.n_layers % every


def _init_uniform_layer(gen, cfg: ModelConfig, use_moe: bool, device,
                        lead=(), dtype=torch.float32) -> Dict:
    """One uniform decoder layer (leaves with the leading axes ``lead``):
    two RMSNorms, GQA or MLA attention, a dense SwiGLU or MoE FFN."""
    ones = lambda: {"scale": torch.ones((*lead, cfg.d_model),
                                        dtype=torch.float32, device=device)}
    init_attn = attn.init_mla if cfg.mla is not None else attn.init_gqa
    return {"ln1": ones(), "ln2": ones(),
            "attn": init_attn(gen, cfg, device=device, lead=lead,
                              dtype=dtype),
            "ffn": (moe.init_moe(gen, cfg, device=device, lead=lead,
                                 dtype=dtype) if use_moe else
                    L.init_swiglu(gen, cfg.d_model, cfg.d_ff, device=device,
                                  lead=lead, dtype=dtype))}


def _init_whisper(gen, cfg: ModelConfig, device, dtype) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    ln = lambda *lead: L.init_layernorm(d, device=device, lead=lead)
    enc, dec = (cfg.n_encoder_layers,), (cfg.n_layers,)
    gqa = lambda lead: attn.init_gqa(gen, cfg, device=device, lead=lead,
                                     dtype=dtype)
    mlp = lambda lead: L.init_gelu_mlp(gen, d, f, device=device, lead=lead,
                                       dtype=dtype)
    return {
        "enc_layers": {"ln1": ln(*enc), "attn": gqa(enc), "ln2": ln(*enc),
                       "mlp": mlp(enc)},
        "enc_norm": ln(),
        "dec_layers": {"ln1": ln(*dec), "self_attn": gqa(dec),
                       "ln2": ln(*dec),
                       "cross_attn": attn.init_cross_attention(
                           gen, cfg, device=device, lead=dec, dtype=dtype),
                       "ln3": ln(*dec), "mlp": mlp(dec)}}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                serving: bool = False) -> Dict:
    """Seeded init with the reference's shapes and scales (N(0, 1/fan_in)
    dense weights, N(0, 0.02^2) embeddings, unit norms, zero biases),
    drawn from a ``torch.Generator`` on ``device``.  ``serving`` returns
    ``serving_params`` of the same draw, leaf for leaf, without the fp32
    tree: each matmul weight is cast to bf16 as soon as it is drawn, so
    the peak is the bf16 copy plus one fp32 leaf (gemma3-12b: ~30 GB
    where the fp32 tree beside its copy would take ~73).

    The numbers differ from ``repro.models.transformer.init_params`` for
    the same seed (a different generator); tests that compare the two
    packages convert the reference's parameters with
    ``params_from_numpy`` instead.  On the ``meta`` device (the dry-run's
    shapes, the reference's ``jax.eval_shape`` of its init) nothing is
    drawn: the leaves have the shapes and dtypes and no data."""
    check_supported(cfg)
    device = torch.device(device)
    dtype = L.COMPUTE_DTYPE if serving else torch.float32
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    n = cfg.n_layers
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": L.init_embedding(gen, cfg.vocab_size, d, device=device),
        "final_norm": L.init_rmsnorm(d, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_embedding(gen, cfg.vocab_size, d,
                                             device=device)
    if cfg.encoder_decoder:
        params.update(_init_whisper(gen, cfg, device, dtype))
        return params
    ones = lambda *lead: {"scale": torch.ones((*lead, d),
                                              dtype=torch.float32,
                                              device=device)}
    pat = _pattern(cfg)
    if pat == "zamba2":
        R, n_periods, rem = _zamba2_shape(cfg)

        def mamba_layers(*lead):
            return {"ln": ones(*lead),
                    "mamba": mamba2.init_mamba2_block(gen, cfg, device=device,
                                                      lead=lead)}
        params["mamba_p"] = mamba_layers(n_periods, R)
        if rem:
            params["mamba_rem"] = mamba_layers(rem)
        params["attn_shared"] = {
            "ln1": ones(), "ln2": ones(),
            "attn": attn.init_gqa(gen, cfg, device=device),
            "ffn": L.init_swiglu(gen, d, cfg.d_ff, device=device)}
    elif pat == "rwkv":
        params["layers"] = {
            "ln1": ones(n),
            "block": rwkv6.init_rwkv_block(gen, cfg, device=device,
                                           lead=(n,))}
    elif pat == "gemma3":
        R, n_periods = _gemma3_shape(cfg)
        params["periods"] = {
            "local": _init_uniform_layer(gen, cfg, False, device,
                                         (n_periods, R), dtype),
            "global": _init_uniform_layer(gen, cfg, False, device,
                                          (n_periods,), dtype)}
    elif _skip_first(cfg):
        params["layer0"] = _init_uniform_layer(gen, cfg, False, device,
                                               dtype=dtype)
        params["layers"] = _init_uniform_layer(gen, cfg, True, device,
                                               (n - 1,), dtype)
    else:
        params["layers"] = _init_uniform_layer(gen, cfg, cfg.moe is not None,
                                               device, (n,), dtype)
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        # the projector stub: pre-projected frontend embeddings at d_embed
        # mapped into the LM by one linear
        de = cfg.frontend.d_embed
        params["mm_proj"] = {"w": torch.randn(
            (de, d), generator=gen, dtype=torch.float32,
            device=device) * de ** -0.5}
    return serving_params(params) if serving else params


def params_from_numpy(tree, device="cuda"):
    """The reference's parameters (a nested dict of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's: the same tree of
    fp32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def serving_params(params) -> Dict:
    """A copy of ``params`` whose layer matmul weights and biases
    (``_MATMUL_LEAVES``, in every stack of ``_STACKS``) are cast to bf16
    once, for serving.  The layers cast them at use anyway, so
    the values the forward sees are identical; the embedding table stays
    fp32 (the unembed is an fp32 product) and so do the norm scales and
    a MoE router.  Leaves already in bf16 are kept, not copied, so the
    result of a ``serving_params`` goes through it again unchanged."""
    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        return tree.to(L.COMPUTE_DTYPE) if key in _MATMUL_LEAVES else tree
    out = dict(params)
    for key in _STACKS:
        if key in params:
            out[key] = cast(params[key])
    return out


def unstack_layers(layers) -> List[Dict]:
    """The stacked layer tree as a list of per-layer trees of views (one
    ``unbind`` per leaf)."""
    def split(tree):
        if isinstance(tree, dict):
            parts = {k: split(v) for k, v in tree.items()}
            n = len(next(iter(parts.values())))
            return [{k: parts[k][i] for k in parts} for i in range(n)]
        return list(torch.unbind(tree, 0))
    return split(layers)


def _attention_params(cfg: ModelConfig) -> int:
    """One GQA (or cross) attention block's parameters, or MLA's."""
    d, H = cfg.d_model, cfg.n_heads
    if cfg.mla is not None:
        m = cfg.mla
        qd = m.nope_head_dim + m.rope_head_dim
        return (d * m.q_lora_rank + m.q_lora_rank * H * qd
                + d * m.kv_lora_rank + d * m.rope_head_dim
                + m.kv_lora_rank * H * (m.nope_head_dim + m.v_head_dim)
                + H * m.v_head_dim * d + m.q_lora_rank + m.kv_lora_rank)
    hd = cfg.resolved_head_dim
    nq, nkv = H * hd, cfg.n_kv_heads * hd
    return (d * nq + 2 * d * nkv + nq * d
            + (nq + 2 * nkv if cfg.qkv_bias else 0))


def _uniform_layer_params(cfg: ModelConfig, use_moe: bool) -> int:
    d = cfg.d_model
    if use_moe:
        m = cfg.moe
        ffn_ = (d * m.n_experts + 3 * m.n_experts * d * m.d_expert_ff
                + 3 * d * m.d_expert_ff * m.n_shared_experts)
    else:
        ffn_ = 3 * d * cfg.d_ff
    return 2 * d + _attention_params(cfg) + ffn_


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count of ``init_params(cfg)``, from shapes alone."""
    check_supported(cfg)
    d, n = cfg.d_model, cfg.n_layers
    total = cfg.vocab_size * d + d
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d
    if cfg.encoder_decoder:
        mlp = 2 * d * cfg.d_ff + cfg.d_ff + d
        attention = _attention_params(cfg)
        return (total + cfg.n_encoder_layers * (4 * d + attention + mlp)
                + 2 * d + n * (6 * d + 2 * attention + mlp))
    pat = _pattern(cfg)
    if pat == "zamba2":
        R, n_periods, rem = _zamba2_shape(cfg)
        layers = ((n_periods * R + rem) * (d + mamba2.block_params(cfg))
                  + _uniform_layer_params(cfg, False))
    elif pat == "rwkv":
        layers = n * (d + rwkv6.block_params(cfg))
    elif _skip_first(cfg):
        layers = (_uniform_layer_params(cfg, False)
                  + (n - 1) * _uniform_layer_params(cfg, True))
    else:
        layers = n * _uniform_layer_params(cfg, cfg.moe is not None
                                           and pat == "uniform")
    total += layers
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        total += cfg.frontend.d_embed * d
    return total


def ffn(lp, h, cfg: ModelConfig):
    """The layer's FFN on h (B, T, d): the MoE (its aux loss dropped) or
    the dense SwiGLU.  The serving path's; training takes the aux loss
    through ``_uniform_layer_seq``."""
    if cfg.moe is not None:
        return moe.moe_forward(lp["ffn"], h, cfg)[0]
    return L.swiglu(lp["ffn"], h)


# ---------------------------------------------------------------------------
# Sequence mode (train / prefill)
# ---------------------------------------------------------------------------

def _uniform_layer_seq(lp, x, cfg: ModelConfig, positions, use_moe: bool,
                       window=None):
    """One layer in sequence mode (GQA over a ``window`` if given, or
    MLA); returns (x, cache, aux): the cache (k, v) or an ``MLACache``."""
    x = constrain_batch(x)
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if cfg.mla is not None:
        a, cache = attn.mla_forward(lp["attn"], h, cfg, positions)
    else:
        a, cache = attn.gqa_forward(lp["attn"], h, cfg, positions,
                                    window=window)
    x = x + a
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if use_moe:
        f, aux = moe.moe_forward(lp["ffn"], h, cfg)
    else:
        f, aux = L.swiglu(lp["ffn"], h), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    return x + f, cache, aux


def _maybe_remat(fn, remat: bool, *args):
    """``fn(*args)``, recomputed in the backward pass when ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _stack_caches(caches):
    """Per-layer caches ((k, v) pairs or ``MLACache``s) as one of the
    same type whose fields are stacked on a new leading axis."""
    stacked = [torch.stack(a) for a in zip(*caches)]
    return (MLACache(*stacked) if isinstance(caches[0], MLACache)
            else tuple(stacked))


def _uniform_forward_seq(params, cfg: ModelConfig, x, positions, remat):
    """The uniform stack, after a dense ``layer0`` for skip_first; returns
    (x, caches, aux): caches stacked (L, ...) as ``_stack_caches``, or
    ``{"first": layer 0's, "rest": the others' stacked}`` for
    skip_first, as the reference's."""
    use_moe = cfg.moe is not None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    first = None
    if _skip_first(cfg):
        x, first, aux = _maybe_remat(_uniform_layer_seq, remat,
                                     params["layer0"], x, cfg, positions,
                                     False)
        aux_total = aux_total + aux
    caches = []
    for lp in unstack_layers(params["layers"]):
        x, cache, aux = _maybe_remat(_uniform_layer_seq, remat, lp, x, cfg,
                                     positions, use_moe)
        aux_total = aux_total + aux
        caches.append(cache)
    caches = _stack_caches(caches)
    if first is not None:
        caches = {"first": first, "rest": caches}
    return x, caches, aux_total


def _gemma3_period_seq(lp, x, cfg: ModelConfig, positions):
    """One gemma3 period: R sliding-window layers, then the global one;
    returns (x, (local k (R, B, T, Hkv, D), local v, global k, v))."""
    lks, lvs = [], []
    for lpi in unstack_layers(lp["local"]):
        x, (k, v), _ = _uniform_layer_seq(lpi, x, cfg, positions, False,
                                          window=cfg.sliding_window)
        lks.append(k)
        lvs.append(v)
    x, (gk, gv), _ = _uniform_layer_seq(lp["global"], x, cfg, positions,
                                        False)
    return x, (torch.stack(lks), torch.stack(lvs), gk, gv)


def _gemma3_forward_seq(params, cfg: ModelConfig, x, positions, remat):
    """The periods, rematerialised per period; returns (x, (local_k (P,
    R, B, T, Hkv, D), local_v, global_k (P, B, T, Hkv, D), global_v))."""
    outs = []
    for lp in unstack_layers(params["periods"]):
        x, out = _maybe_remat(_gemma3_period_seq, remat, lp, x, cfg,
                              positions)
        outs.append(out)
    return x, tuple(torch.stack(a) for a in zip(*outs))


# ---------------------------------------------------------------------------
# Whisper: encoder and decoder
# ---------------------------------------------------------------------------

def _sinusoid(positions, d: int):
    """The reference's ``_sinusoid_pos`` rows at ``positions`` (any
    shape of integers): (..., d) fp32, [sin | cos] of pos / 10000^(2i/d)."""
    i = torch.arange(d // 2, dtype=torch.float32,
                     device=positions.device)
    angles = positions[..., None].float() / (10000.0 ** (2 * i / d))
    return torch.cat([torch.sin(angles), torch.cos(angles)], -1)


def _bidir_attn(p, h, cfg: ModelConfig, recompute: bool):
    """The encoder's self attention: no mask, no RoPE; ``recompute``: its
    (B, H, S_enc, S_enc) probabilities, as ``L.recomputed``'s ``on``."""
    B, T, _ = h.shape
    q, k, v = attn._project_qkv(p, h, cfg)
    out = L.recomputed(recompute, attn._sdpa, q, k, v, None,
                       1.0 / math.sqrt(cfg.resolved_head_dim))
    return out.reshape(B, T, -1) @ p["wo"].to(h.dtype)


def _encoder_layer(lp, x, cfg: ModelConfig, recompute: bool):
    x = constrain_batch(x)
    h = L.layernorm(lp["ln1"], x, cfg.norm_eps, recompute)
    x = x + _bidir_attn(lp["attn"], h, cfg, recompute)
    h = L.layernorm(lp["ln2"], x, cfg.norm_eps, recompute)
    return x + L.gelu_mlp(lp["mlp"], h, recompute)


def whisper_encode(params, cfg: ModelConfig, frames, remat: bool = False):
    """frames: (B, S_enc, d) precomputed frontend embeddings (the stub),
    plus the sinusoid positions, through the bidirectional encoder and
    its final LayerNorm.  ``remat`` recomputes each layer in the backward
    pass; without it the LayerNorms, GELUs and attention probabilities
    are still recomputed (``L.recomputed``), and the rest is kept."""
    T = frames.shape[1]
    pos = _sinusoid(torch.arange(T, device=frames.device), cfg.d_model)
    x = frames.to(L.COMPUTE_DTYPE) + pos.to(L.COMPUTE_DTYPE)
    for lp in unstack_layers(params["enc_layers"]):
        x = _maybe_remat(_encoder_layer, remat, lp, x, cfg, not remat)
    return L.layernorm(params["enc_norm"], x, cfg.norm_eps, not remat)


def _decoder_layer_seq(lp, x, enc_out, cfg: ModelConfig, positions,
                       recompute: bool):
    """One decoder layer, teacher-forced; returns (x, (k, v, cross k,
    cross v)).  ``recompute`` as ``_encoder_layer``'s."""
    x = constrain_batch(x)
    h = L.layernorm(lp["ln1"], x, cfg.norm_eps, recompute)
    a, (k, v) = attn.gqa_forward(lp["self_attn"], h, cfg, positions)
    x = x + a
    h = L.layernorm(lp["ln2"], x, cfg.norm_eps, recompute)
    ckv = attn.project_cross_kv(lp["cross_attn"], enc_out, cfg)
    x = x + attn.cross_attention(lp["cross_attn"], h, ckv, cfg, recompute)
    h = L.layernorm(lp["ln3"], x, cfg.norm_eps, recompute)
    return x + L.gelu_mlp(lp["mlp"], h, recompute), (k, v, *ckv)


def whisper_decode_seq(params, cfg: ModelConfig, tokens, enc_out,
                       remat: bool = False):
    """The decoder over ``tokens`` (B, T) against ``enc_out``; returns
    (hidden (B, T, d), caches (self k, self v, cross k, cross v) each
    stacked (L, ...)).  The reference applies no final norm here.
    ``remat`` as ``whisper_encode``'s."""
    B, T = tokens.shape
    x = L.embed(params["embed"], tokens)
    x = x + _sinusoid(torch.arange(T, device=x.device),
                      cfg.d_model).to(L.COMPUTE_DTYPE)
    positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
    outs = []
    for lp in unstack_layers(params["dec_layers"]):
        x, out = _maybe_remat(_decoder_layer_seq, remat, lp, x, enc_out, cfg,
                              positions, not remat)
        outs.append(out)
    return x, tuple(torch.stack(a) for a in zip(*outs))


def _whisper_decode(params, cfg: ModelConfig, caches, x, pos):
    """The decode step's layers for whisper, x (B, 1, d) embedded; the
    cross K/V are read, not written.  Returns (x, new caches)."""
    S = caches.self_k.shape[2]
    pos_t = torch.as_tensor(pos, device=x.device)
    # dynamic_slice clamps the start so that the row fits
    pe = _sinusoid(torch.clamp(pos_t, max=S - 1).reshape(1), cfg.d_model)
    x = x + pe.to(L.COMPUTE_DTYPE)
    sks, svs = [], []
    for lp, sk, sv, ck, cv in zip(unstack_layers(params["dec_layers"]),
                                  caches.self_k, caches.self_v,
                                  caches.cross_k, caches.cross_v):
        h = L.layernorm(lp["ln1"], x, cfg.norm_eps)
        a, sk, sv = attn.gqa_decode(lp["self_attn"], h, cfg, sk, sv, pos)
        x = x + a
        h = L.layernorm(lp["ln2"], x, cfg.norm_eps)
        x = x + attn.cross_attention(lp["cross_attn"], h, (ck, cv), cfg)
        h = L.layernorm(lp["ln3"], x, cfg.norm_eps)
        x = x + L.gelu_mlp(lp["mlp"], h)
        sks.append(sk)
        svs.append(sv)
    return x, caches._replace(self_k=torch.stack(sks),
                              self_v=torch.stack(svs))


def _embed_inputs(params, cfg: ModelConfig, tokens, extra_embeds):
    """tokens: (B, T_text); extra_embeds: (B, T_img, d_embed) or None.
    VLM: image embeddings are projected by ``mm_proj`` and prepended to
    the text."""
    x = L.embed(params["embed"], tokens)
    if extra_embeds is not None and "mm_proj" in params:
        img = (extra_embeds.to(L.COMPUTE_DTYPE)
               @ params["mm_proj"]["w"].to(L.COMPUTE_DTYPE))
        x = torch.cat([img, x], dim=1)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
    return x, positions


def forward_seq(params, cfg: ModelConfig, tokens, extra_embeds=None,
                remat: bool = False, encoder_frames=None,
                last_only: bool = False, return_hidden: bool = False):
    """Full-sequence causal forward, no pages: tokens (B, T_text) ->
    (logits (B, T, V) fp32, caches, aux), aux the MoE load-balance loss
    summed over layers (0 without a MoE FFN).  The caches are the
    reference's, sized to T: uniform (k, v) each (L, B, T, Hkv, D), or
    an ``MLACache`` of (L, B, T, r) and (L, B, T, dr), and for skip_first
    ``{"first": layer 0's, "rest": the others' stacked}``; gemma3
    (local k, local v (P, R, B, T, Hkv, D), global k, global v (P, B, T,
    Hkv, D)); zamba2 ``_zamba2_forward_seq``'s six stacks; rwkv an
    ``RWKVState`` of (L, ...) stacks; whisper (self k, self v (L, B, T,
    Hkv, D), cross k, cross v (L, B, S_enc, Hkv, D)).  The uniform
    forward is also the plain end-to-end yardstick of the paged engine.

    ``remat`` recomputes each layer (a gemma3 or zamba2 period) in the
    backward pass (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint`` of its scan body; for whisper the reference
    checkpoints nothing, which gives the same numbers); ``last_only``
    unembeds only the last position; ``return_hidden`` returns the
    final-normed hidden states (B, T, d) in place of the logits (whisper:
    the decoder's output, which the reference does not norm).  Given a
    vision frontend, ``extra_embeds`` (B, T_img, d_embed) are prepended
    to the text, T = T_img + T_text.  An encoder-decoder model needs
    ``encoder_frames`` (B, S_enc, d).  With a MoE FFN a token's output
    depends on the other tokens of the call through capacity.  A zamba2
    forward on CUDA with no gradient runs the SSD scan kernel in every
    Mamba2 layer (``models/mamba2.py``)."""
    check_supported(cfg)
    if cfg.encoder_decoder:
        if encoder_frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder forward needs "
                             "encoder_frames (B, S_enc, d)")
        enc_out = whisper_encode(params, cfg, encoder_frames, remat)
        x, caches = whisper_decode_seq(params, cfg, tokens, enc_out, remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if return_hidden:
            return x, caches, aux
        if last_only:
            x = x[:, -1:]
        # whisper ties its output to the embedding table
        return L.unembed(params["embed"], x), caches, aux
    x, positions = _embed_inputs(params, cfg, tokens, extra_embeds)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    pat = _pattern(cfg)
    if pat == "zamba2":
        x, caches = _zamba2_forward_seq(params, cfg, x, positions, remat)
    elif pat == "rwkv":
        states = []
        for lp in unstack_layers(params["layers"]):
            x, st = _maybe_remat(_rwkv_layer_seq, remat, lp, x, cfg)
            states.append(st)
        caches = rwkv6.RWKVState(*(torch.stack(a) for a in zip(*states)))
    elif pat == "gemma3":
        x, caches = _gemma3_forward_seq(params, cfg, x, positions, remat)
    else:
        x, caches, aux_total = _uniform_forward_seq(params, cfg, x,
                                                    positions, remat)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        return x, caches, aux_total
    if last_only:
        x = x[:, -1:]
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return L.unembed(head, x), caches, aux_total


def _rwkv_layer_seq(lp, x, cfg: ModelConfig):
    """One RWKV6 layer in sequence mode from the zero state; returns
    (x, ``RWKVState``)."""
    x = constrain_batch(x)
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    st = rwkv6.init_rwkv_state(cfg, x.shape[0], dtype=x.dtype,
                               device=x.device)
    h, st = rwkv6.rwkv_block_forward(lp["block"], h, cfg, st)
    return x + h, st


def _mamba_layer_seq(lp, x, cfg: ModelConfig):
    """One Mamba2 layer in sequence mode from a fresh state (so a no-grad
    CUDA forward takes the scan kernel); returns (x, ``MambaState``)."""
    x = constrain_batch(x)
    h = L.rmsnorm(lp["ln"], x, cfg.norm_eps)
    h, st = mamba2.mamba2_block_forward(lp["mamba"], h, cfg)
    return x + h, st


def _shared_block_seq(ap, x, cfg: ModelConfig, positions):
    """zamba2's shared attention block; returns (x, (k, v))."""
    h = L.rmsnorm(ap["ln1"], x, cfg.norm_eps)
    a, kv = attn.gqa_forward(ap["attn"], h, cfg, positions)
    x = x + a
    h = L.rmsnorm(ap["ln2"], x, cfg.norm_eps)
    return x + L.swiglu(ap["ffn"], h), kv


def _mamba_stack_seq(layers, x, cfg: ModelConfig):
    """The Mamba2 layers of a stack (leaves (n, ...)) in turn; returns
    (x, conv (n, B, K-1, C), S (n, B, H, N, Pd))."""
    convs, ssms = [], []
    for lp in unstack_layers(layers):
        x, st = _mamba_layer_seq(lp, x, cfg)
        convs.append(st.conv)
        ssms.append(st.S)
    return x, torch.stack(convs), torch.stack(ssms)


def _zamba2_period_seq(lp, ap, x, cfg: ModelConfig, positions):
    """One period: R Mamba2 layers (``lp`` leaves (R, ...)), then the
    shared block ``ap``.  Returns (x, (conv (R, ...), S (R, ...), k, v))."""
    x, conv, ssm = _mamba_stack_seq(lp, x, cfg)
    x, (k, v) = _shared_block_seq(ap, x, cfg, positions)
    return x, (conv, ssm, k, v)


def _zamba2_forward_seq(params, cfg: ModelConfig, x, positions,
                        remat: bool = False):
    """The Mamba2 periods with their shared attention block, then the
    remainder layers (not rematerialised, as in the reference).  Returns
    (x, (conv_p (P, R, B, K-1, C), ssm_p (P, R, B, H, N, Pd), conv_rem
    (rem, ...) or None, ssm_rem or None, k (P, B, T, Hkv, D), v))."""
    ap = params["attn_shared"]
    outs = []
    for lp in unstack_layers(params["mamba_p"]):
        x, out = _maybe_remat(_zamba2_period_seq, remat, lp, ap, x, cfg,
                              positions)
        outs.append(out)
    conv_p, ssm_p, ak, av = (torch.stack(a) for a in zip(*outs))
    conv_rem = ssm_rem = None
    if "mamba_rem" in params:
        x, conv_rem, ssm_rem = _mamba_stack_seq(params["mamba_rem"], x, cfg)
    return x, (conv_p, ssm_p, conv_rem, ssm_rem, ak, av)


# ---------------------------------------------------------------------------
# Contiguous decode caches and the decode step
# ---------------------------------------------------------------------------

class KVCaches(NamedTuple):
    k: torch.Tensor            # (L, B, S, Hkv, D)
    v: torch.Tensor


class MLACaches(NamedTuple):
    latent: torch.Tensor       # (L, B, S, r)
    k_rope: torch.Tensor       # (L, B, S, rope_dim)


class Gemma3Caches(NamedTuple):
    local_k: torch.Tensor      # (P, R, B, W, Hkv, D)  ring buffers
    local_v: torch.Tensor
    global_k: torch.Tensor     # (P, B, S, Hkv, D)
    global_v: torch.Tensor


class Zamba2Caches(NamedTuple):
    conv_p: torch.Tensor       # (P, R, B, K-1, C)
    ssm_p: torch.Tensor        # (P, R, B, H, N, Pd) fp32
    conv_rem: torch.Tensor     # (max(rem, 1), B, K-1, C)
    ssm_rem: torch.Tensor      # (max(rem, 1), B, H, N, Pd) fp32
    attn_k: torch.Tensor       # (P, B, S, Hkv, D)
    attn_v: torch.Tensor


class RWKVCaches(NamedTuple):
    shift_tm: torch.Tensor     # (L, B, d)
    shift_cm: torch.Tensor     # (L, B, d)
    S: torch.Tensor            # (L, B, H, N, N) fp32


class WhisperCaches(NamedTuple):
    self_k: torch.Tensor       # (L, B, S, Hkv, D)
    self_v: torch.Tensor
    cross_k: torch.Tensor      # (L, B, S_enc, Hkv, D)
    cross_v: torch.Tensor


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                kv_dtype=None, device="cuda"):
    """Zero decode caches of the config's pattern; ``kv_dtype`` overrides
    the bf16 storage of attention K/V (``torch.int8`` for the quantised
    cache; whisper's self K/V, not its cross K/V); other states keep
    their own dtypes (bf16 MLA latents, windows and shifts, fp32 S).
    gemma3's local rings hold min(window, cache_len) slots."""
    check_supported(cfg)
    dt = kv_dtype if kv_dtype is not None else L.COMPUTE_DTYPE
    kv_shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                             device=device)
    n = cfg.n_layers
    if cfg.encoder_decoder:
        cross = (n, batch, cfg.n_encoder_tokens, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return WhisperCaches(self_k=zeros((n, *kv_shape), dt),
                             self_v=zeros((n, *kv_shape), dt),
                             cross_k=zeros(cross, L.COMPUTE_DTYPE),
                             cross_v=zeros(cross, L.COMPUTE_DTYPE))
    if cfg.mla is not None:
        m = cfg.mla
        return MLACaches(
            latent=zeros((n, batch, cache_len, m.kv_lora_rank),
                         L.COMPUTE_DTYPE),
            k_rope=zeros((n, batch, cache_len, m.rope_head_dim),
                         L.COMPUTE_DTYPE))
    pat = _pattern(cfg)
    if pat == "gemma3":
        R, P = _gemma3_shape(cfg)
        W = min(cfg.sliding_window, cache_len)
        ring = (batch, W, *kv_shape[2:])
        return Gemma3Caches(local_k=zeros((P, R, *ring), dt),
                            local_v=zeros((P, R, *ring), dt),
                            global_k=zeros((P, *kv_shape), dt),
                            global_v=zeros((P, *kv_shape), dt))
    if pat == "zamba2":
        R, P, rem = _zamba2_shape(cfg)
        s, _, H, conv_ch = mamba2._dims(cfg)
        conv = (batch, s.conv_kernel - 1, conv_ch)
        ssm = (batch, H, s.state_dim, s.head_dim)
        return Zamba2Caches(
            conv_p=zeros((P, R, *conv), L.COMPUTE_DTYPE),
            ssm_p=zeros((P, R, *ssm), torch.float32),
            conv_rem=zeros((max(rem, 1), *conv), L.COMPUTE_DTYPE),
            ssm_rem=zeros((max(rem, 1), *ssm), torch.float32),
            attn_k=zeros((P, *kv_shape), dt),
            attn_v=zeros((P, *kv_shape), dt))
    if pat == "rwkv":
        N = cfg.rwkv.head_dim
        return RWKVCaches(
            shift_tm=zeros((n, batch, cfg.d_model), L.COMPUTE_DTYPE),
            shift_cm=zeros((n, batch, cfg.d_model), L.COMPUTE_DTYPE),
            S=zeros((n, batch, cfg.n_heads, N, N), torch.float32))
    return KVCaches(k=zeros((n, *kv_shape), dt),
                    v=zeros((n, *kv_shape), dt))


def _uniform_layer_decode(lp, x, cfg: ModelConfig, cache, pos,
                          use_moe: bool, window=None, ring: bool = False):
    """One layer of the decode step: x (B, 1, d) against the layer's
    cache, (k, v) (a ring of slots with ``ring``) or an ``MLACache``
    (absorbed-weight MLA); returns (x, the new cache of the same type)."""
    x = constrain_batch(x)
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if cfg.mla is not None:
        a, cache = attn.mla_decode(lp["attn"], h, cfg, cache, pos)
    else:
        ck, cv = cache
        a, ck, cv = attn.gqa_decode(lp["attn"], h, cfg, ck, cv, pos,
                                    window=window, ring=ring)
        cache = (ck, cv)
    x = x + a
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if use_moe:
        f, _ = moe.moe_forward(lp["ffn"], h, cfg)
    else:
        f = L.swiglu(lp["ffn"], h)
    return x + f, cache


def _uniform_decode(params, cfg: ModelConfig, caches, x, pos):
    """The uniform stack's decode step over ``KVCaches`` or
    ``MLACaches`` (layer 0 dense for skip_first); returns (x, caches)."""
    use_moe = cfg.moe is not None
    layers = [(lp, use_moe) for lp in unstack_layers(params["layers"])]
    if _skip_first(cfg):
        layers.insert(0, (params["layer0"], False))
    mla = isinstance(caches, MLACaches)
    new = []
    for (lp, moe_layer), a, b in zip(layers, *caches):
        x, cache = _uniform_layer_decode(
            lp, x, cfg, MLACache(a, b) if mla else (a, b), pos, moe_layer)
        new.append(cache)
    return x, type(caches)(*(torch.stack(t) for t in zip(*new)))


def _gemma3_decode(params, cfg: ModelConfig, caches: Gemma3Caches, x, pos):
    """Each period's R local layers against their rings of W slots, then
    its global layer; returns (x, new ``Gemma3Caches``)."""
    W = caches.local_k.shape[3]
    out = []
    for lp, lk, lv, gk, gv in zip(unstack_layers(params["periods"]),
                                  *caches):
        lks, lvs = [], []
        for lpi, ck, cv in zip(unstack_layers(lp["local"]), lk, lv):
            x, (ck, cv) = _uniform_layer_decode(lpi, x, cfg, (ck, cv), pos,
                                                False, window=W, ring=True)
            lks.append(ck)
            lvs.append(cv)
        x, (gk, gv) = _uniform_layer_decode(lp["global"], x, cfg, (gk, gv),
                                            pos, False)
        out.append((torch.stack(lks), torch.stack(lvs), gk, gv))
    return x, Gemma3Caches(*(torch.stack(t) for t in zip(*out)))


def _mamba_stack_decode(layers, x, cfg: ModelConfig, conv, S):
    """The decode step through a Mamba2 stack (leaves (n, ...)) against
    its states conv (n, B, K-1, C) and S (n, B, H, N, Pd); returns (x,
    new conv, new S)."""
    convs, ssms = [], []
    for lp, ci, si in zip(unstack_layers(layers), conv, S):
        h = L.rmsnorm(lp["ln"], x, cfg.norm_eps)
        h, st = mamba2.mamba2_block_decode(lp["mamba"], h, cfg,
                                           mamba2.MambaState(ci, si))
        x = x + h
        convs.append(st.conv)
        ssms.append(st.S)
    return x, torch.stack(convs), torch.stack(ssms)


def _zamba2_decode(params, cfg: ModelConfig, caches: Zamba2Caches, x, pos):
    ap = params["attn_shared"]
    convs_p, ssms_p, ks, vs = [], [], [], []
    for lp, conv, S, ak, av in zip(unstack_layers(params["mamba_p"]),
                                   caches.conv_p, caches.ssm_p,
                                   caches.attn_k, caches.attn_v):
        x, conv, S = _mamba_stack_decode(lp, x, cfg, conv, S)
        h = L.rmsnorm(ap["ln1"], x, cfg.norm_eps)
        a, ak, av = attn.gqa_decode(ap["attn"], h, cfg, ak, av, pos)
        x = x + a
        h = L.rmsnorm(ap["ln2"], x, cfg.norm_eps)
        x = x + L.swiglu(ap["ffn"], h)
        convs_p.append(conv)
        ssms_p.append(S)
        ks.append(ak)
        vs.append(av)
    conv_rem, ssm_rem = caches.conv_rem, caches.ssm_rem
    if "mamba_rem" in params:
        x, conv_rem, ssm_rem = _mamba_stack_decode(
            params["mamba_rem"], x, cfg, conv_rem, ssm_rem)
    return x, Zamba2Caches(torch.stack(convs_p), torch.stack(ssms_p),
                           conv_rem, ssm_rem, torch.stack(ks),
                           torch.stack(vs))


def _rwkv_decode(params, cfg: ModelConfig, caches: RWKVCaches, x):
    states = []
    for lp, stm, scm, S in zip(unstack_layers(params["layers"]),
                               caches.shift_tm, caches.shift_cm, caches.S):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        h, st = rwkv6.rwkv_block_decode(lp["block"], h, cfg,
                                        rwkv6.RWKVState(stm, scm, S))
        x = x + h
        states.append(st)
    return x, RWKVCaches(*(torch.stack(a) for a in zip(*states)))


def decode_step(params, cfg: ModelConfig, caches, token, pos):
    """One decode step against contiguous caches (``init_caches``' type
    for the config).  token: (B,) int; pos: an int or 0-d tensor, the
    tokens already cached.  Returns (logits (B, V) fp32, new caches);
    ``caches`` is left unchanged."""
    check_supported(cfg)
    x = L.embed(params["embed"], token[:, None])           # (B, 1, d)
    if cfg.encoder_decoder:
        x, new_caches = _whisper_decode(params, cfg, caches, x, pos)
        return L.unembed(params["embed"], x[:, 0]), new_caches
    pat = _pattern(cfg)
    if pat == "zamba2":
        x, new_caches = _zamba2_decode(params, cfg, caches, x, pos)
    elif pat == "rwkv":
        x, new_caches = _rwkv_decode(params, cfg, caches, x)
    elif pat == "gemma3":
        x, new_caches = _gemma3_decode(params, cfg, caches, x, pos)
    else:
        x, new_caches = _uniform_decode(params, cfg, caches, x, pos)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return L.unembed(head, x[:, 0]), new_caches
