"""Mixture-of-Experts FFN with top-k routing (OLMoE style).

Counterpart of ``repro/models/moe.py``, with its semantics kept exactly:
an fp32 router and softmax, top-k with renormalised gates, a Switch aux
loss, ``capacity = max(ceil(n_tok * K / E * capacity_factor), 4)``,
ranks within an expert from an exclusive cumsum in token-major
``(N * K)`` order, pairs past capacity dropped, a per-expert SwiGLU in
the activations' dtype and a gated combine.  A row's output therefore
depends on the other rows of its call through capacity, as in the
reference.

The decode step runs this body inside a captured CUDA graph, so every
launch follows from shapes alone: no host synchronisation and no
data-dependent shape.  Where the reference scatters with ``mode="drop"``
the buffers carry one more column (the drop slot, sliced off), and the
sentinel token is one more row of zeros.  The combine gathers each
(token, k) pair's expert output and sums a token's K contributions in
the activations' dtype in increasing expert id, the order in which the
reference's ``out.at[buf_tok].add(...)`` adds them; no float atomics, so
two calls on the same inputs are bit-equal.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import layers as L
from repro_torch.models.sharding import constrain_experts


def init_moe(gen: torch.Generator, cfg: ModelConfig, device=None, lead=(),
             dtype=torch.float32):
    """The reference's ``init_moe`` shapes and scales (router N(0, 0.02^2),
    experts N(0, 1/fan_in)); ``lead`` is the stacked layer axis, ``dtype``
    the experts' storage (the router stays fp32)."""
    m: MoEConfig = cfg.moe
    d, f, E = cfg.d_model, m.d_expert_ff, m.n_experts
    p = {
        "router": L._dense_init(gen, (*lead, d, E), scale=0.02,
                                device=device),
        "w_gate": L._dense_init(gen, (*lead, E, d, f), device=device,
                                dtype=dtype),
        "w_up": L._dense_init(gen, (*lead, E, d, f), device=device,
                              dtype=dtype),
        "w_down": L._dense_init(gen, (*lead, E, f, d), device=device,
                                dtype=dtype),
    }
    if m.n_shared_experts:
        p["shared"] = L.init_swiglu(gen, d, f * m.n_shared_experts,
                                    device=device, lead=lead, dtype=dtype)
    return p


def capacity(n_tok: int, m: MoEConfig) -> int:
    """Slots per expert for a call over ``n_tok`` tokens."""
    return max(int(math.ceil(n_tok * m.top_k / m.n_experts
                             * m.capacity_factor)), 4)


class Plan(NamedTuple):
    """The routing of one call over N tokens.

    probs (N, E) fp32; eids, gates (N, K): the top-k experts (ties to the
    lower id) and their renormalised fp32 gates; slot (N, K): each pair's
    rank within its expert, ``capacity`` where the pair is dropped."""
    probs: torch.Tensor
    eids: torch.Tensor
    gates: torch.Tensor
    slot: torch.Tensor
    capacity: int


def route(router, xf, m: MoEConfig) -> Plan:
    """The reference's routing of the (N, d) tokens ``xf``."""
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                    # (N, E)
    # jax.lax.top_k breaks ties towards the lower index; a stable sort
    # keeps equal probabilities in index order
    eids = torch.sort(probs, dim=-1, descending=True,
                      stable=True).indices[:, :m.top_k]
    return plan_for(probs, eids, m)


def plan_for(probs, eids, m: MoEConfig) -> Plan:
    """The plan that sends each token to the experts ``eids`` (N, K):
    the gates renormalised from ``probs``, and the slots."""
    n_tok, K = eids.shape
    gates = probs.gather(1, eids)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    cap = capacity(n_tok, m)
    flat = eids.reshape(-1)                                  # (N*K,)
    onehot = (flat[:, None] == torch.arange(
        m.n_experts, device=eids.device)).to(torch.int32)
    ranks = (torch.cumsum(onehot, dim=0) - onehot).gather(
        1, flat[:, None])[:, 0]                              # exclusive
    slot = torch.where(ranks >= cap, cap, ranks).reshape(n_tok, K)
    return Plan(probs, eids, gates, slot, cap)


def aux_loss(plan: Plan, E: int):
    """Switch load-balance loss: E * sum_e f_e * p_e."""
    me = torch.mean(plan.probs, dim=0)
    top1 = (plan.eids[:, :1] == torch.arange(E, device=me.device))
    ce = torch.mean(top1.float(), dim=0)
    return E * torch.sum(me * ce)


def moe_forward(p, x, cfg: ModelConfig):
    """x: (B, T, d) -> (out (B, T, d) in x's dtype, aux_loss fp32)."""
    m: MoEConfig = cfg.moe
    B, T, d = x.shape
    dt = x.dtype
    xf = x.reshape(B * T, d)
    n_tok = B * T
    E, K = m.n_experts, m.top_k
    plan = route(p["router"], xf, m)
    cap = plan.capacity

    # ---- gather tokens into (E, C) buffers, column C the drop slot -------
    flat_slot = (plan.eids * (cap + 1) + plan.slot).reshape(-1)
    tok_idx = torch.arange(n_tok * K, device=x.device) // K
    buf_tok = torch.full((E * (cap + 1),), n_tok, dtype=torch.long,
                         device=x.device)
    buf_tok.scatter_(0, flat_slot, tok_idx)
    buf_gate = torch.zeros((E * (cap + 1),), dtype=torch.float32,
                           device=x.device)
    buf_gate.scatter_(0, flat_slot, plan.gates.reshape(-1))
    buf_tok = buf_tok.view(E, cap + 1)[:, :cap]
    buf_gate = buf_gate.view(E, cap + 1)[:, :cap]
    x_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    xe = x_pad[buf_tok]                                      # (E, C, d)
    xe = constrain_experts(xe)                               # EP over model

    # ---- expert compute (per-expert SwiGLU) -------------------------------
    g = torch.bmm(xe, p["w_gate"].to(dt))
    u = torch.bmm(xe, p["w_up"].to(dt))
    ye = torch.bmm(L.silu(g) * u, p["w_down"].to(dt))       # (E, C, d)
    ye_w = ye * buf_gate[..., None].to(dt)

    # ---- combine: each token's pairs in increasing expert id --------------
    ye_rows = torch.cat([ye_w.reshape(E * cap, d), ye_w.new_zeros((1, d))])
    row = torch.where(plan.slot < cap, plan.eids * cap + plan.slot,
                      E * cap)                               # (N, K)
    order = torch.argsort(plan.eids, dim=-1)
    contrib = ye_rows[row.gather(1, order)]                  # (N, K, d)
    out = torch.zeros((n_tok, d), dtype=dt, device=x.device)
    for k in range(K):
        out = out + contrib[:, k]

    if m.n_shared_experts:
        out = out + L.swiglu(p["shared"], xf)
    return out.reshape(B, T, d), aux_loss(plan, E)
