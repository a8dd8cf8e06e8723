"""Parameters, the plain sequence forward and the contiguous-cache decode
step of every layer pattern the port runs.

Counterpart of ``repro/models/transformer.py`` (``init_params``,
``forward_seq``, the cache tuples, ``init_caches``, ``decode_step``) for:
  * the uniform pattern with GQA attention and a dense or MoE FFN
    (qwen2-1.5b, llama3.2-3b, mistral-nemo-12b, olmoe-1b-7b, and
    llava-next-mistral-7b's language model behind its vision stub);
  * zamba2 (zamba2-7b): periods of ``hybrid_attn_every - 1`` Mamba2
    layers and one attention block whose parameters are SHARED by every
    period, then a remainder of Mamba2 layers;
  * rwkv (rwkv6-1.6b): RWKV6 blocks in every layer.
Parameters keep the reference's STACKED layout — every per-layer leaf
carries the leading axes ``_stack_init`` gives it — so
``params_from_numpy`` converts the reference's parameters leaf by leaf:

    {"embed": {"table"}, "final_norm": {"scale"}, ["lm_head": {"table"}],
     uniform: "layers": {"ln1": {"scale"}, "ln2": {"scale"},
                "attn": {"wq", "wk", "wv", "wo", ["bq", "bk", "bv"]},
                "ffn": {"w_gate", "w_up", "w_down"}      (dense)
                    or {"router", "w_gate", "w_up", "w_down",
                        ["shared": {"w_gate", "w_up", "w_down"}]}  (MoE)},
              ["mm_proj": {"w"}];
     zamba2:  "mamba_p": {"ln": {"scale"}, "mamba": {...}}  (P, R, ...),
              ["mamba_rem": the same, (rem, ...)],
              "attn_shared": {"ln1", "ln2", "attn", "ffn"}  (one block);
     rwkv:    "layers": {"ln1": {"scale"}, "block": {...}}  (L, ...)}
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba2, moe, rwkv6

# leaves of the layer stacks that are matrix-product weights or biases
# (cast at use by every layer); norm scales stay fp32 (the reference
# multiplies fp32 activations by them), and so do a MoE router (the
# reference routes in fp32) and the SSM blocks' decays, A_log, dt_bias,
# u_bonus, mixes and LoRA factors
_MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv",
                  "w_gate", "w_up", "w_down",
                  "w_in", "w_out",                         # mamba2
                  "w_r", "w_k", "w_v", "w_g", "w_o",       # rwkv6 time mix
                  "cm_wr", "cm_wk", "cm_wv")               # rwkv6 channel mix
# the parameter stacks, by layer pattern
_STACKS = ("layers", "mamba_p", "mamba_rem", "attn_shared")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet:
    MLA attention, a skip_first MoE, the local_global layer pattern and
    encoder-decoder models (ROADMAP queue 1 item 5).  A vision frontend
    is a stub whose embeddings ``forward_seq`` takes as
    ``extra_embeds``; serving ignores it, as the reference's does."""
    moe_ok = cfg.moe is None or cfg.moe.layer_pattern == "all"
    frontend_ok = cfg.frontend is None or cfg.frontend.kind == "vision"
    if (_pattern(cfg) not in ("uniform", "zamba2", "rwkv") or not moe_ok
            or cfg.mla is not None or cfg.encoder_decoder
            or not frontend_ok):
        raise NotImplementedError(
            f"{cfg.name}: the port runs uniform GQA decoders (dense or "
            "all-layer MoE FFN), zamba2 and rwkv; MLA attention, a "
            "skip_first MoE, the local_global pattern, encoder-decoder "
            "models and audio frontends are not ported yet (ROADMAP queue "
            "1 item 5)")


def _pattern(cfg: ModelConfig) -> str:
    lp = cfg.layer_pattern
    return "gemma3" if lp.startswith("local_global") else lp


def _zamba2_shape(cfg: ModelConfig):
    """(Mamba2 layers per period R, periods P, remainder layers)."""
    every = cfg.hybrid_attn_every
    return every - 1, cfg.n_layers // every, cfg.n_layers % every


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict:
    """Seeded init with the reference's shapes and scales (N(0, 1/fan_in)
    dense weights, N(0, 0.02^2) embeddings, unit norms, zero biases),
    drawn from a ``torch.Generator`` on ``device``.

    The numbers differ from ``repro.models.transformer.init_params`` for
    the same seed (a different generator); tests that compare the two
    packages convert the reference's parameters with
    ``params_from_numpy`` instead."""
    check_supported(cfg)
    device = torch.device(device)
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
    else:
        params["layers"] = {
            "ln1": ones(n), "ln2": ones(n),
            "attn": attn.init_gqa(gen, cfg, device=device, lead=(n,)),
            "ffn": (moe.init_moe(gen, cfg, device=device, lead=(n,))
                    if cfg.moe is not None else
                    L.init_swiglu(gen, d, cfg.d_ff, device=device,
                                  lead=(n,))),
        }
    if cfg.frontend is not None:
        # the projector stub: pre-projected frontend embeddings at d_embed
        # mapped into the LM by one linear
        de = cfg.frontend.d_embed
        params["mm_proj"] = {"w": torch.randn(
            (de, d), generator=gen, dtype=torch.float32,
            device=device) * de ** -0.5}
    return params


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


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count of ``init_params(cfg)``, from shapes alone."""
    check_supported(cfg)
    d, hd, n = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    attention = 2 * d + d * nq + 2 * d * nkv + nq * d   # with its 2 norms
    if cfg.qkv_bias:
        attention += nq + 2 * nkv
    pat = _pattern(cfg)
    if pat == "zamba2":
        R, n_periods, rem = _zamba2_shape(cfg)
        layers = ((n_periods * R + rem) * (d + mamba2.block_params(cfg))
                  + attention + 3 * d * cfg.d_ff)
    elif pat == "rwkv":
        layers = n * (d + rwkv6.block_params(cfg))
    elif cfg.moe is not None:
        m = cfg.moe
        layers = n * (attention + d * m.n_experts
                      + 3 * m.n_experts * d * m.d_expert_ff
                      + 3 * d * m.d_expert_ff * m.n_shared_experts)
    else:
        layers = n * (attention + 3 * d * cfg.d_ff)
    total = cfg.vocab_size * d + d + layers
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d
    if cfg.frontend is not None:
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

def _uniform_layer_seq(lp, x, cfg: ModelConfig, positions, use_moe: bool):
    """One layer in sequence mode; returns (x, (k, v), aux)."""
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    a, cache = attn.gqa_forward(lp["attn"], h, cfg, positions)
    x = x + a
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if use_moe:
        f, aux = moe.moe_forward(lp["ffn"], h, cfg)
    else:
        f, aux = L.swiglu(lp["ffn"], h), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    return x + f, cache, aux


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
    reference's, sized to T: uniform (k, v) each (L, B, T, Hkv, D);
    zamba2 ``_zamba2_forward_seq``'s six stacks; rwkv an ``RWKVState``
    of (L, ...) stacks.  The uniform forward is also the plain
    end-to-end yardstick of the paged engine.

    ``remat`` recomputes each layer (a zamba2 period) in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of
    its scan body); ``last_only`` unembeds only the last position;
    ``return_hidden`` returns the final-normed hidden states (B, T, d) in
    place of the logits.  Given a vision frontend, ``extra_embeds``
    (B, T_img, d_embed) are prepended to the text, T = T_img + T_text.
    ``encoder_frames`` is taken for the reference's signature and unused:
    no encoder-decoder config passes ``check_supported``.  With a MoE FFN
    a token's output depends on the other tokens of the call through
    capacity.  A zamba2 forward on CUDA with no gradient runs the SSD
    scan kernel in every Mamba2 layer (``models/mamba2.py``)."""
    check_supported(cfg)
    x, positions = _embed_inputs(params, cfg, tokens, extra_embeds)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    pat = _pattern(cfg)
    if pat == "zamba2":
        x, caches = _zamba2_forward_seq(params, cfg, x, positions, remat)
    elif pat == "rwkv":
        states = []
        for lp in unstack_layers(params["layers"]):
            x, st = (checkpoint(_rwkv_layer_seq, lp, x, cfg,
                                use_reentrant=False)
                     if remat else _rwkv_layer_seq(lp, x, cfg))
            states.append(st)
        caches = rwkv6.RWKVState(*(torch.stack(a) for a in zip(*states)))
    else:
        use_moe = cfg.moe is not None
        ks, vs = [], []
        for lp in unstack_layers(params["layers"]):
            if remat:
                x, (k, v), aux = checkpoint(_uniform_layer_seq, lp, x, cfg,
                                            positions, use_moe,
                                            use_reentrant=False)
            else:
                x, (k, v), aux = _uniform_layer_seq(lp, x, cfg, positions,
                                                    use_moe)
            aux_total = aux_total + aux
            ks.append(k)
            vs.append(v)
        caches = (torch.stack(ks), torch.stack(vs))
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
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    st = rwkv6.init_rwkv_state(cfg, x.shape[0], dtype=x.dtype,
                               device=x.device)
    h, st = rwkv6.rwkv_block_forward(lp["block"], h, cfg, st)
    return x + h, st


def _mamba_layer_seq(lp, x, cfg: ModelConfig):
    """One Mamba2 layer in sequence mode from a fresh state (so a no-grad
    CUDA forward takes the scan kernel); returns (x, ``MambaState``)."""
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
        if remat:
            x, out = checkpoint(_zamba2_period_seq, lp, ap, x, cfg,
                                positions, use_reentrant=False)
        else:
            x, out = _zamba2_period_seq(lp, ap, x, cfg, positions)
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


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                kv_dtype=None, device="cuda"):
    """Zero decode caches of the config's pattern; ``kv_dtype`` overrides
    the bf16 storage of attention K/V (``torch.int8`` for the quantised
    cache); recurrent states keep their own dtypes (bf16 windows and
    shifts, fp32 S)."""
    check_supported(cfg)
    dt = kv_dtype if kv_dtype is not None else L.COMPUTE_DTYPE
    kv_shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                             device=device)
    pat = _pattern(cfg)
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
            shift_tm=zeros((cfg.n_layers, batch, cfg.d_model),
                           L.COMPUTE_DTYPE),
            shift_cm=zeros((cfg.n_layers, batch, cfg.d_model),
                           L.COMPUTE_DTYPE),
            S=zeros((cfg.n_layers, batch, cfg.n_heads, N, N),
                    torch.float32))
    return KVCaches(k=zeros((cfg.n_layers, *kv_shape), dt),
                    v=zeros((cfg.n_layers, *kv_shape), dt))


def _uniform_layer_decode(lp, x, cfg: ModelConfig, cache, pos,
                          use_moe: bool):
    """One layer of the decode step: x (B, 1, d) against the layer's
    cache (k, v); returns (x, (k, v)) with new caches."""
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    ck, cv = cache
    a, ck, cv = attn.gqa_decode(lp["attn"], h, cfg, ck, cv, pos)
    x = x + a
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if use_moe:
        f, _ = moe.moe_forward(lp["ffn"], h, cfg)
    else:
        f = L.swiglu(lp["ffn"], h)
    return x + f, (ck, cv)


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
    pat = _pattern(cfg)
    if pat == "zamba2":
        x, new_caches = _zamba2_decode(params, cfg, caches, x, pos)
    elif pat == "rwkv":
        x, new_caches = _rwkv_decode(params, cfg, caches, x)
    else:
        use_moe = cfg.moe is not None
        ks, vs = [], []
        for lp, ck, cv in zip(unstack_layers(params["layers"]), caches.k,
                              caches.v):
            x, (ck, cv) = _uniform_layer_decode(lp, x, cfg, (ck, cv), pos,
                                                use_moe)
            ks.append(ck)
            vs.append(cv)
        new_caches = KVCaches(torch.stack(ks), torch.stack(vs))
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return L.unembed(head, x[:, 0]), new_caches
