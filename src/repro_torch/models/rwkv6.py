"""RWKV6 "Finch" block: time-mix with data-dependent decay + channel-mix.

Counterpart of ``repro/models/rwkv6.py`` (arXiv:2404.05892):
  * token shift with data-dependent linear interpolation (ddlerp,
    LoRA-based) for the r/k/v/w/g branches;
  * per-channel decay  w_t = exp(-exp(w0 + lora_w(x_w)))  in (0, 1);
  * recurrence  S_t = diag(w_t) S_{t-1} + k_t^T v_t,
    read  o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)  (u = per-channel bonus);
  * group norm over heads, silu(g) gate, output projection;
  * channel mix: r = sigmoid(W_r x_r), k = relu(W_k x_k)^2, out = r * W_v k.

Sequence mode runs ``models/gla.py::gla_chunked`` in rwkv mode with the
u-bonus, as the reference does (no kernel computes a per-channel decay);
decode is the O(1) state update.  State = (token_shift_tm,
token_shift_cm, S) per layer.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RWKVConfig
from repro_torch.models.gla import gla_chunked, gla_decode_step
from repro_torch.models.layers import _dense_init, silu


class RWKVState(NamedTuple):
    shift_tm: torch.Tensor   # (B, d) last token seen by time-mix
    shift_cm: torch.Tensor   # (B, d) last token seen by channel-mix
    S: torch.Tensor          # (B, H, N, N) recurrence state (fp32)


def init_rwkv_block(gen: torch.Generator, cfg: ModelConfig, device=None,
                    lead=()):
    """The reference's leaves, shapes and scales, each with the leading
    stacked axes ``lead``."""
    r: RWKVConfig = cfg.rwkv
    d, H, N, R = cfg.d_model, cfg.n_heads, r.head_dim, r.decay_lora_rank
    if H * N != d:
        raise ValueError(f"rwkv requires n_heads*head_dim == d_model "
                         f"({H}*{N} != {d})")
    full = lambda shape, value: torch.full((*lead, *shape), value,
                                           dtype=torch.float32,
                                           device=device)
    dense = lambda shape, scale=None: _dense_init(gen, (*lead, *shape),
                                                  scale=scale, device=device)
    # decay init spread across channels as in the reference
    ramp = torch.arange(d, dtype=torch.float32, device=device) / max(d - 1, 1)
    decay_speed = -6.0 + 5.0 * ramp ** 0.9
    return {
        # ddlerp base mixes (mu) and LoRA for the r, k, v, w, g branches
        "mu_base": full((5, d), 0.5),
        "lora_A": dense((d, 5 * R), 0.01),
        "lora_B": dense((5, R, d), 0.01),
        "w_r": dense((d, d)),
        "w_k": dense((d, d)),
        "w_v": dense((d, d)),
        "w_g": dense((d, d)),
        "w_o": dense((d, d)),
        "decay_base": decay_speed.expand(*lead, d).clone(),   # w0
        "decay_lora_A": dense((d, R), 0.01),
        "decay_lora_B": dense((R, d), 0.01),
        "u_bonus": full((H, N), 0.5),
        "gn_scale": full((d,), 1.0),
        "gn_bias": full((d,), 0.0),
        # channel mix
        "cm_mu": full((2, d), 0.5),                            # r, k
        "cm_wr": dense((d, d)),
        "cm_wk": dense((d, cfg.d_ff)),
        "cm_wv": dense((cfg.d_ff, d)),
    }


def block_params(cfg: ModelConfig) -> int:
    """Parameters of one block (``init_rwkv_block`` without ``lead``)."""
    d, R = cfg.d_model, cfg.rwkv.decay_lora_rank
    return (5 * d + 2 * 5 * R * d + 5 * d * d + d + 2 * d * R
            + cfg.n_heads * cfg.rwkv.head_dim + 2 * d + 2 * d + d * d
            + 2 * d * cfg.d_ff)


def _ddlerp(p, x, x_prev):
    """Data-dependent lerp between the current and the shifted token for
    the 5 branches.  x, x_prev: (B, T, d).  Returns (5, B, T, d)."""
    dt = x.dtype
    delta = x_prev - x
    base = x + delta * p["mu_base"][:, None, None, :].to(dt)   # (5,B,T,d)
    lora = torch.tanh(x @ p["lora_A"].to(dt))                  # (B,T,5R)
    R = p["lora_B"].shape[1]
    lora = lora.reshape(*lora.shape[:-1], 5, R)
    adj = torch.einsum("btfr,frd->fbtd", lora, p["lora_B"].to(dt))
    return base + adj * delta[None]


def _group_norm(x, scale, bias, n_heads: int, eps: float = 1e-5):
    """x: (B, T, d) normalised per head, in fp32."""
    B, T, d = x.shape
    xg = x.reshape(B, T, n_heads, d // n_heads).float()
    mu = torch.mean(xg, -1, keepdim=True)
    var = torch.var(xg, -1, keepdim=True, unbiased=False)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return (xg.reshape(B, T, d) * scale + bias).to(x.dtype)


def _time_mix_qkvwg(p, x, x_prev, cfg: ModelConfig):
    B, T, d = x.shape
    H, N = cfg.n_heads, cfg.rwkv.head_dim
    dt = x.dtype
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev)
    heads = lambda a: a.reshape(B, T, H, N).transpose(1, 2)
    rr = heads(xr @ p["w_r"].to(dt))
    kk = heads(xk @ p["w_k"].to(dt))
    vv = heads(xv @ p["w_v"].to(dt))
    g = silu(xg @ p["w_g"].to(dt))                               # (B,T,d)
    # data-dependent per-channel decay, logw <= 0
    dlo = torch.tanh(xw @ p["decay_lora_A"].to(dt)) \
        @ p["decay_lora_B"].to(dt)
    logw = -torch.exp(p["decay_base"].float() + dlo.float())     # (B,T,d)
    return rr, kk, vv, heads(logw), g


def _channel_mix(p, h, h_prev):
    dt = h.dtype
    delta = h_prev - h
    hr = h + delta * p["cm_mu"][0].to(dt)
    hk = h + delta * p["cm_mu"][1].to(dt)
    rgate = torch.sigmoid(hr @ p["cm_wr"].to(dt))
    kk2 = torch.square(torch.relu(hk @ p["cm_wk"].to(dt)))
    return rgate * (kk2 @ p["cm_wv"].to(dt))


def rwkv_block_forward(p, x, cfg: ModelConfig, state: RWKVState
                       ) -> Tuple[torch.Tensor, RWKVState]:
    """Sequence mode.  x: (B, T, d)."""
    B, T, d = x.shape
    # token shift: the previous token (state.shift_tm for t = 0)
    x_prev = torch.cat([state.shift_tm[:, None, :], x[:, :-1]], dim=1)
    rr, kk, vv, logw, g = _time_mix_qkvwg(p, x, x_prev, cfg)
    y, S = gla_chunked(rr, kk, vv, logw, u=p["u_bonus"], mode="rwkv",
                       chunk=min(cfg.rwkv.chunk_size, T),
                       initial_state=state.S)
    y = y.transpose(1, 2).reshape(B, T, d)
    y = _group_norm(y, p["gn_scale"], p["gn_bias"], cfg.n_heads)
    h = x + (y * g) @ p["w_o"].to(x.dtype)
    h_prev = torch.cat([state.shift_cm[:, None, :], h[:, :-1]], dim=1)
    out = h + _channel_mix(p, h, h_prev)
    return out, RWKVState(shift_tm=x[:, -1, :], shift_cm=h[:, -1, :], S=S)


def rwkv_block_decode(p, x, cfg: ModelConfig, state: RWKVState
                      ) -> Tuple[torch.Tensor, RWKVState]:
    """Decode one token.  x: (B, 1, d)."""
    B, _, d = x.shape
    rr, kk, vv, logw, g = _time_mix_qkvwg(p, x, state.shift_tm[:, None, :],
                                          cfg)
    y, S = gla_decode_step(rr[:, :, 0], kk[:, :, 0], vv[:, :, 0],
                           logw[:, :, 0], state.S, u=p["u_bonus"],
                           mode="rwkv")
    y = _group_norm(y.reshape(B, 1, d), p["gn_scale"], p["gn_bias"],
                    cfg.n_heads)
    h = x + (y * g) @ p["w_o"].to(x.dtype)
    out = h + _channel_mix(p, h, state.shift_cm[:, None, :])
    return out, RWKVState(shift_tm=x[:, 0, :], shift_cm=h[:, 0, :], S=S)


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                    device=None) -> RWKVState:
    r: RWKVConfig = cfg.rwkv
    return RWKVState(
        shift_tm=torch.zeros((batch, cfg.d_model), dtype=dtype,
                             device=device),
        shift_cm=torch.zeros((batch, cfg.d_model), dtype=dtype,
                             device=device),
        S=torch.zeros((batch, cfg.n_heads, r.head_dim, r.head_dim),
                      dtype=torch.float32, device=device))
