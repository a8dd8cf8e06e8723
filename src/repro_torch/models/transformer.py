"""Parameters and the plain sequence forward of a uniform decoder.

Counterpart of ``repro/models/transformer.py``, for the uniform layer
pattern with GQA attention and a dense or MoE FFN (qwen2-1.5b,
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

import math
from typing import Any, Dict, List

import numpy as np
import torch

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
    the dense SwiGLU."""
    if cfg.moe is not None:
        return moe.moe_forward(lp["ffn"], h, cfg)[0]
    return L.swiglu(lp["ffn"], h)


def forward_seq(params, cfg: ModelConfig, tokens, extra_embeds=None):
    """Plain full-sequence causal forward, no pages: tokens (B, T_text)
    -> (logits (B, T, V) fp32, (k, v) each (L, B, T, Hkv, D)).  The
    reference's ``forward_seq`` for the uniform pattern; it also serves
    as the plain end-to-end yardstick of the paged engine.  Given a
    vision frontend, ``extra_embeds`` (B, T_img, d_embed) are projected
    by ``mm_proj`` and prepended to the text, T = T_img + T_text, as the
    reference's ``_embed_inputs``.  With a MoE FFN a token's output
    depends on the other tokens of the call through capacity."""
    check_supported(cfg)
    x = L.embed(params["embed"], tokens)
    if extra_embeds is not None and "mm_proj" in params:
        img = (extra_embeds.to(L.COMPUTE_DTYPE)
               @ params["mm_proj"]["w"].to(L.COMPUTE_DTYPE))
        x = torch.cat([img, x], dim=1)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    mask = (torch.arange(T, device=x.device)[None, :]
            <= torch.arange(T, device=x.device)[:, None])[None, None]
    ks, vs = [], []
    for lp in unstack_layers(params["layers"]):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = attn._project_qkv(lp["attn"], h, cfg)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        a = attn._sdpa(q, k, v, mask, scale)
        x = x + a.reshape(B, T, -1) @ lp["attn"]["wo"].to(x.dtype)
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + ffn(lp, h, cfg)
        ks.append(k)
        vs.append(v)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return L.unembed(head, x), (torch.stack(ks), torch.stack(vs))
