"""Parameters and the plain sequence forward of a uniform decoder.

Counterpart of ``repro/models/transformer.py`` (``init_params``,
``forward_seq``, ``KVCaches``, ``init_caches``, ``decode_step``), for the
uniform layer pattern with GQA attention and a dense or MoE FFN (qwen2-1.5b,
llama3.2-3b, mistral-nemo-12b, olmoe-1b-7b, and llava-next-mistral-7b's
language model behind its vision stub).  Parameters keep the reference's
STACKED layout — every per-layer leaf carries a leading ``n_layers``
axis, as ``_stack_init`` builds it — so ``params_from_numpy`` converts the
reference's parameters leaf by leaf:

    {"embed": {"table"}, "final_norm": {"scale"},
     "layers": {"ln1": {"scale"}, "ln2": {"scale"},
                "attn": {"wq", "wk", "wv", "wo", ["bq", "bk", "bv"]},
                "ffn": {"w_gate", "w_up", "w_down"}      (dense)
                    or {"router", "w_gate", "w_up", "w_down",
                        ["shared": {"w_gate", "w_up", "w_down"}]}  (MoE)},
     ["lm_head": {"table"}], ["mm_proj": {"w"}]}
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe

# leaves of the layer stack that are matrix-product weights or biases;
# norm scales stay fp32 (the reference multiplies fp32 activations by
# them), and so does a MoE router (the reference routes in fp32)
_MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv",
                  "w_gate", "w_up", "w_down")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not serve:
    anything but a uniform GQA decoder whose FFN is dense or MoE in every
    layer.  A vision frontend is a stub whose embeddings ``forward_seq``
    takes as ``extra_embeds``; serving ignores it, as the reference's
    does."""
    moe_ok = cfg.moe is None or cfg.moe.layer_pattern == "all"
    frontend_ok = cfg.frontend is None or cfg.frontend.kind == "vision"
    if (cfg.layer_pattern != "uniform" or not moe_ok
            or cfg.mla is not None or cfg.encoder_decoder
            or not frontend_ok):
        raise NotImplementedError(
            f"{cfg.name}: the port serves uniform GQA decoders with a "
            "dense or all-layer MoE FFN only (MLA, skip_first MoE and the "
            "other layer patterns are not ported yet)")


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
    ones = torch.ones((n, d), dtype=torch.float32, device=device)
    params["layers"] = {
        "ln1": {"scale": ones.clone()},
        "ln2": {"scale": ones.clone()},
        "attn": attn.init_gqa(gen, cfg, device=device, lead=(n,)),
        "ffn": (moe.init_moe(gen, cfg, device=device, lead=(n,))
                if cfg.moe is not None else
                L.init_swiglu(gen, d, cfg.d_ff, device=device, lead=(n,))),
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
    """A copy of ``params`` whose layer matmul weights and biases are cast
    to bf16 once, for serving.  The layers cast them at use anyway, so
    the values the forward sees are identical; the embedding table stays
    fp32 (the unembed is an fp32 product) and so do the norm scales and
    a MoE router.  Leaves already in bf16 are kept, not copied, so the
    result of a ``serving_params`` goes through it again unchanged."""
    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        return tree.to(L.COMPUTE_DTYPE) if key in _MATMUL_LEAVES else tree
    out = dict(params)
    out["layers"] = cast(params["layers"])
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
    per_layer = 2 * d + d * nq + 2 * d * nkv + nq * d
    if cfg.moe is not None:
        m = cfg.moe
        per_layer += (d * m.n_experts + 3 * m.n_experts * d * m.d_expert_ff
                      + 3 * d * m.d_expert_ff * m.n_shared_experts)
    else:
        per_layer += 3 * d * cfg.d_ff
    if cfg.qkv_bias:
        per_layer += nq + 2 * nkv
    total = cfg.vocab_size * d + d + n * per_layer
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
    (logits (B, T, V) fp32, (k, v) each (L, B, T, Hkv, D), aux), aux the
    MoE load-balance loss summed over layers (0 for a dense FFN).  The
    reference's ``forward_seq`` for the uniform pattern; it is also the
    plain end-to-end yardstick of the paged engine.

    ``remat`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of
    its scan body); ``last_only`` unembeds only the last position;
    ``return_hidden`` returns the final-normed hidden states (B, T, d) in
    place of the logits.  Given a vision frontend, ``extra_embeds``
    (B, T_img, d_embed) are prepended to the text, T = T_img + T_text.
    ``encoder_frames`` is taken for the reference's signature and unused:
    no encoder-decoder config passes ``check_supported``.  With a MoE FFN
    a token's output depends on the other tokens of the call through
    capacity."""
    check_supported(cfg)
    x, positions = _embed_inputs(params, cfg, tokens, extra_embeds)
    use_moe = cfg.moe is not None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
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


# ---------------------------------------------------------------------------
# Contiguous decode caches and the decode step
# ---------------------------------------------------------------------------

class KVCaches(NamedTuple):
    k: torch.Tensor            # (L, B, S, Hkv, D)
    v: torch.Tensor


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                kv_dtype=None, device="cuda") -> KVCaches:
    """Zero decode caches; ``kv_dtype`` overrides the bf16 KV storage
    dtype (``torch.int8`` for the quantised cache)."""
    check_supported(cfg)
    dt = kv_dtype if kv_dtype is not None else L.COMPUTE_DTYPE
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return KVCaches(k=torch.zeros(shape, dtype=dt, device=device),
                    v=torch.zeros(shape, dtype=dt, device=device))


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


def decode_step(params, cfg: ModelConfig, caches: KVCaches, token, pos):
    """One decode step against contiguous caches.  token: (B,) int; pos:
    an int or 0-d tensor, the tokens already cached.  Returns (logits
    (B, V) fp32, new ``KVCaches``); ``caches`` is left unchanged."""
    check_supported(cfg)
    x = L.embed(params["embed"], token[:, None])           # (B, 1, d)
    use_moe = cfg.moe is not None
    ks, vs = [], []
    for lp, ck, cv in zip(unstack_layers(params["layers"]), caches.k,
                          caches.v):
        x, (ck, cv) = _uniform_layer_decode(lp, x, cfg, (ck, cv), pos,
                                            use_moe)
        ks.append(ck)
        vs.append(cv)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return L.unembed(head, x[:, 0]), KVCaches(torch.stack(ks),
                                               torch.stack(vs))
