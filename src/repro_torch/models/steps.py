"""Step functions of the contiguous-cache path: train_step / prefill /
serve_step.

Counterpart of ``repro/models/steps.py`` for every config of the
registry.  They operate on contiguous
decode caches (``transformer.init_caches``); the serving engine's paged
decode path lives in ``core/`` and ``models/paged.py``.  Each runs
eagerly: the reference's launcher jits its train step, and capturing
this one as a CUDA graph is later work (``ROADMAP.md``).
"""
from __future__ import annotations

import functools
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.attention import MLACache
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.train.optimizer import (AdamWState, adamw_init,
                                         adamw_update, tree_leaves,
                                         tree_map)

AUX_LOSS_WEIGHT = 0.01


# ---------------------------------------------------------------------------
# Loss / train step
# ---------------------------------------------------------------------------

CE_CHUNK = 512


def chunked_ce_loss(hidden, head_table, labels, chunk: int = CE_CHUNK):
    """Mean cross-entropy over the labels >= 0 without the full (B, T, V)
    logits at once: the sequence is padded to a multiple of ``chunk``
    (label -1) and taken ``chunk`` positions at a time, each an fp32
    product of the hidden states and the fp32 head table, as the
    reference's scan."""
    B, T, d = hidden.shape
    pad = (-T) % chunk
    if pad:
        hidden = torch.cat([hidden, hidden.new_zeros((B, pad, d))], dim=1)
        labels = torch.cat([labels, labels.new_full((B, pad), -1)], dim=1)
    w = head_table.float()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, hidden.shape[1], chunk):
        hc, lc = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        logits = hc.float() @ w.T                              # (B, c, V)
        lse = torch.logsumexp(logits, dim=-1)
        safe = torch.clamp(lc, min=0)
        ll = torch.gather(logits, -1, safe[..., None].long())[..., 0]
        mask = (lc >= 0).float()
        total = total + torch.sum((lse - ll) * mask)
        count = count + torch.sum(mask)
    return total / torch.clamp(count, min=1.0)


def lm_loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True) -> torch.Tensor:
    """Next-token loss of ``batch`` (``tokens``, ``labels`` (B, T),
    ``extra_embeds`` for a VLM, ``encoder_frames`` for an encoder-decoder)
    plus ``AUX_LOSS_WEIGHT`` times the MoE aux loss.  A VLM's image
    positions are prepended and not scored."""
    labels = batch["labels"]
    hidden, _, aux = T.forward_seq(
        params, cfg, batch["tokens"], extra_embeds=batch.get("extra_embeds"),
        encoder_frames=batch.get("encoder_frames"), remat=remat,
        return_hidden=True)
    if hidden.shape[1] != labels.shape[1]:
        hidden = hidden[:, hidden.shape[1] - labels.shape[1]:]
    head = params["embed"] if (cfg.tie_embeddings or "lm_head" not in params) \
        else params["lm_head"]
    loss = chunked_ce_loss(hidden, head["table"], labels)
    return loss + AUX_LOSS_WEIGHT * aux


def loss_and_grads(params, cfg: ModelConfig, batch, remat: bool = True):
    """(loss, grads): ``lm_loss`` and its gradient tree w.r.t. every
    leaf of ``params`` (the reference's ``jax.value_and_grad``); a leaf
    the loss does not use (whisper's ``final_norm``) gets zeros, as
    there.  ``params`` itself is not marked for autograd."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = lm_loss(leaves, cfg, batch, remat=remat)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, grads))
    return loss.detach(), tree_map(lambda _: next(it), leaves)


def train_step(params, opt_state: AdamWState, batch, *, cfg: ModelConfig,
               lr: float = 3e-4, remat: bool = True):
    """One AdamW step on ``lm_loss``.  Returns (params, opt_state, loss);
    the parameters and moments are updated in place
    (``optimizer.adamw_update``)."""
    loss, grads = loss_and_grads(params, cfg, batch, remat=remat)
    new_params, new_opt = adamw_update(grads, opt_state, params, lr=lr)
    return new_params, new_opt, loss


def make_train_step(cfg: ModelConfig, lr: float = 3e-4, remat: bool = True):
    return functools.partial(train_step, cfg=cfg, lr=lr, remat=remat)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, extra_embeds=None,
            encoder_frames=None):
    """Returns (last-position logits (B, V), caches) with
    ``forward_seq``'s caches sized to the prompt (uniform: (k, v) each
    (L, B, T, Hkv, D)); ``caches_from_prefill`` pads them to a decode
    budget.  Runs without autograd, so a zamba2 prefill on CUDA takes the
    SSD scan kernel in every Mamba2 layer."""
    logits, caches, _ = T.forward_seq(params, cfg, tokens,
                                      extra_embeds=extra_embeds,
                                      encoder_frames=encoder_frames,
                                      remat=False, last_only=True)
    return logits[:, -1], caches


def make_prefill(cfg: ModelConfig):
    return functools.partial(prefill, cfg=cfg)


def _put(dst, src, axis: int):
    """Write ``src`` into ``dst`` (in place) at offset 0 along ``axis``,
    cast to ``dst``'s dtype."""
    index = [slice(None)] * dst.dim()
    index[axis] = slice(0, src.shape[axis])
    dst[tuple(index)] = src.to(dst.dtype)


def caches_from_prefill(cfg: ModelConfig, raw, batch: int, cache_len: int):
    """``prefill``'s caches as the decode caches of ``cache_len``
    positions (``init_caches``' type for the config), in their dtypes
    (the reference's cast: an int8 cache is filled by ``serve_step``,
    which quantises).  Attention K/V and MLA latents are written at
    offset 0 of zero caches (skip_first's layer 0 put in front of the
    others); gemma3's local rings keep the prompt's last W positions
    where it holds at least W, rolled by (T - W) % W so that position p
    lands in slot p % W, as ``gqa_decode``'s ring writes them; whisper's
    cross K/V and the recurrent states (zamba2's conv windows and SSM
    states, rwkv's token shifts and S) are taken whole."""
    T.check_supported(cfg)
    pat = T._pattern(cfg)
    if pat == "rwkv":
        return T.RWKVCaches(shift_tm=raw.shift_tm.to(COMPUTE_DTYPE),
                            shift_cm=raw.shift_cm.to(COMPUTE_DTYPE),
                            S=raw.S)
    if isinstance(raw, dict):                      # skip_first
        first, rest = raw["first"], raw["rest"]
        merged = [torch.cat([a[None], b]) for a, b in zip(first, rest)]
        raw = (MLACache(*merged) if isinstance(rest, MLACache)
               else tuple(merged))
    device = next(iter(raw)).device
    full = T.init_caches(cfg, batch, cache_len, device=device)
    if cfg.encoder_decoder:
        sk, sv, ck, cv = raw
        _put(full.self_k, sk, 2)
        _put(full.self_v, sv, 2)
        return full._replace(cross_k=ck.to(full.cross_k.dtype),
                             cross_v=cv.to(full.cross_v.dtype))
    if cfg.mla is not None:
        _put(full.latent, raw.latent, 2)
        _put(full.k_rope, raw.k_rope, 2)
        return full
    if pat == "gemma3":
        lk, lv, gk, gv = raw                       # lk (P, R, B, T, H, D)
        W, Tp = full.local_k.shape[3], lk.shape[3]
        for dst, src in ((full.local_k, lk), (full.local_v, lv)):
            if Tp >= W:
                # the last W tokens, position p in slot p % W
                dst[...] = torch.roll(src[:, :, :, Tp - W:],
                                      shifts=(Tp - W) % W,
                                      dims=3).to(dst.dtype)
            else:
                _put(dst, src, 3)
        _put(full.global_k, gk, 2)
        _put(full.global_v, gv, 2)
        return full
    if pat == "zamba2":
        conv_p, ssm_p, conv_rem, ssm_rem, k, v = raw
        full = full._replace(
            conv_p=conv_p.to(full.conv_p.dtype),
            ssm_p=ssm_p.to(full.ssm_p.dtype),
            conv_rem=(full.conv_rem if conv_rem is None
                      else conv_rem.to(full.conv_rem.dtype)),
            ssm_rem=(full.ssm_rem if ssm_rem is None
                     else ssm_rem.to(full.ssm_rem.dtype)))
        fk, fv = full.attn_k, full.attn_v
    else:
        k, v = raw
        fk, fv = full.k, full.v
    _put(fk, k, 2)
    _put(fv, v, 2)
    return full


# ---------------------------------------------------------------------------
# Serve (decode) step
# ---------------------------------------------------------------------------

@torch.no_grad()
def serve_step(params, caches, token, pos, *, cfg: ModelConfig):
    """One new token for every sequence against a ``pos``-token cache.
    Returns (next_token (B,) int32, logits (B, V), new caches): greedy."""
    logits, new_caches = T.decode_step(params, cfg, caches, token, pos)
    next_token = torch.argmax(logits, dim=-1).to(torch.int32)
    return next_token, logits, new_caches


def make_serve_step(cfg: ModelConfig):
    return functools.partial(serve_step, cfg=cfg)


def init_train_state(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """(params, AdamW state) from the port's seeded init on ``device``."""
    params = T.init_params(cfg, seed=seed, device=device)
    return params, adamw_init(params)
