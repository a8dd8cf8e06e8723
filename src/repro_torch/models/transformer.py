"""Parameters and the plain sequence forward of a uniform dense decoder.

Counterpart of ``repro/models/transformer.py``, for the uniform dense GQA
layer pattern only (qwen2-1.5b).  Parameters keep the reference's
STACKED layout — every per-layer leaf carries a leading ``n_layers``
axis, as ``_stack_init`` builds it — so ``params_from_numpy`` converts the
reference's parameters leaf by leaf:

    {"embed": {"table"}, "final_norm": {"scale"},
     "layers": {"ln1": {"scale"}, "ln2": {"scale"},
                "attn": {"wq", "wk", "wv", "wo", ["bq", "bk", "bv"]},
                "ffn": {"w_gate", "w_up", "w_down"}},
     ["lm_head": {"table"}]}
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

# leaves of the layer stack that are matrix-product weights or biases;
# norm scales stay fp32 (the reference multiplies fp32 activations by them)
_MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv",
                  "w_gate", "w_up", "w_down")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice of the port does
    not serve: anything but a uniform dense GQA decoder."""
    if (cfg.layer_pattern != "uniform" or cfg.moe is not None
            or cfg.mla is not None or cfg.encoder_decoder
            or cfg.frontend is not None):
        raise NotImplementedError(
            f"{cfg.name}: the port serves uniform dense GQA decoders only "
            "(MoE, MLA and the other layer patterns are not ported yet)")


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
        "ffn": L.init_swiglu(gen, d, cfg.d_ff, device=device, lead=(n,)),
    }
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
    fp32 (the unembed is an fp32 product) and so do the norm scales."""
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
    per_layer = (2 * d + d * nq + 2 * d * nkv + nq * d
                 + 3 * d * cfg.d_ff)
    if cfg.qkv_bias:
        per_layer += nq + 2 * nkv
    total = cfg.vocab_size * d + d + n * per_layer
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d
    return total


def forward_seq(params, cfg: ModelConfig, tokens):
    """Plain full-sequence causal forward, no pages: tokens (B, T) ->
    (logits (B, T, V) fp32, (k, v) each (L, B, T, Hkv, D)).  The
    reference's ``forward_seq`` for the uniform dense pattern; it also
    serves as the plain end-to-end yardstick of the paged engine."""
    check_supported(cfg)
    B, T = tokens.shape
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    mask = (torch.arange(T, device=tokens.device)[None, :]
            <= torch.arange(T, device=tokens.device)[:, None])[None, None]
    ks, vs = [], []
    for lp in unstack_layers(params["layers"]):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = attn._project_qkv(lp["attn"], h, cfg)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        a = attn._sdpa(q, k, v, mask, scale)
        x = x + a.reshape(B, T, -1) @ lp["attn"]["wo"].to(x.dtype)
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + L.swiglu(lp["ffn"], h)
        ks.append(k)
        vs.append(v)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return L.unembed(head, x), (torch.stack(ks), torch.stack(vs))
