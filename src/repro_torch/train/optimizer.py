"""AdamW, the reference's arithmetic in its order.

Counterpart of ``repro/train/optimizer.py``: fp32 moments, bias
corrections ``1 - b ** t`` in fp32, ``delta = mhat / (sqrt(vhat) + eps)
+ weight_decay * p`` and ``p - lr * delta`` cast back to the leaf's
dtype.  ``torch.optim.AdamW`` decays the weights before the step
(``p *= 1 - lr * wd``), which gives other numbers, so it is not used.

The update writes the parameters and moments in place (the reference
returns new trees; here the old ones are not needed again, as a donated
buffer is not), so a step holds no second copy of the state.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor


class AdamWState(NamedTuple):
    step: torch.Tensor        # 0-d int32
    mu: Any                   # the params' tree of fp32 tensors
    nu: Any


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of tensors (the first
    tree's structure)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The tensors of nested dicts, tuples and lists, depth first in key
    order as given."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def adamw_init(params) -> AdamWState:
    """Zero fp32 moments beside every leaf, step 0 on the params'
    device."""
    device = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


# elements of a leaf updated at once: the update's temporaries (a few
# fp32 copies of what it works on) stay at ~64 MB each, where a whole
# leaf's (gemma3-12b's 262144 x 3840 embedding: 4 GB) lift its
# one-period train step's peak from 54.2 to 73.9 GB, more than the card
# has left beside chip_smoke's other phases
ADAMW_CHUNK = 1 << 24


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr=3e-4, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.01):
    """One AdamW step; ``params``, ``state.mu`` and ``state.nu`` are
    written in place, ``ADAMW_CHUNK`` elements of a leaf at a time (each
    element's arithmetic is the same).  Returns (params, the new
    ``AdamWState``).  No host synchronisation: the step count stays on
    the device."""
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def upd_chunk(g, m, v, p):
        g = g.float()
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g) * (1 - b2))
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        p.copy_((p - lr * delta).to(p.dtype))

    def upd(g, m, v, p):
        if isinstance(p, DTensor):
            # the dry-run's trace: each device updates its local shards
            # whole (flattening a leaf sharded on two dims would gather it)
            return upd_chunk(g, m, v, p)
        g, m, v, p = g.reshape(-1), m.view(-1), v.view(-1), p.view(-1)
        for a in range(0, p.numel(), ADAMW_CHUNK):
            b = a + ADAMW_CHUNK
            upd_chunk(g[a:b], m[a:b], v[a:b], p[a:b])

    tree_map(upd, grads, state.mu, state.nu, params)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
