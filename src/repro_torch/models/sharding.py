"""The serving half of the head-sharded tensor-parallel layout.

Counterpart of ``repro/models/sharding.py:180-232``.  The serving layout
shards output-channel dims only: the q/k/v projections' columns (the
fused ``heads * head_dim`` axis) and their biases, the KV pool's, the
swap slab's and the prefill carry's head axis, and the per-head
attention that reads them.  No contraction dim is split, so no
cross-shard sum reorders a float reduction: each shard computes a slice
of the one-device activations, the head concatenation is a layout
operation, and ``wo``, the MLP or MoE, the norms and the sampler run
replicated.

The reference states the layout as ``PartitionSpec`` trees and lets
``shard_map`` place the pieces.  Here a spec is a tuple with one entry
per axis, ``"model"`` on the sharded axis and ``None`` elsewhere (``()``
replicated), and ``shard_params`` makes the per-shard trees itself.  A
sharded value is a list of per-shard tensors in shard order.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

SERVING_SHARDED_PARAMS = ("wq", "wk", "wv", "bq", "bk", "bv")

# the head axis of each head-sharded value: the reference's pool, slab and
# carry specs shard it over "model" and nothing else
POOL_HEAD_AXIS = 4       # (L, 2, num_blocks, block_size, Hkv, D)
SLAB_HEAD_AXIS = 3       # (L * 2, n_slab, block_size, Hkv, D)
CARRY_HEAD_AXIS = 2      # (L, S_pad, Hkv, D)


def serving_param_pspecs(params) -> Any:
    """The spec tree of ``params`` for the serving step: the attention
    q/k/v projections and their biases sharded over ``model`` on the
    LAST axis (under the stacked layer axis too), every other leaf
    replicated (``()``)."""
    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if name in SERVING_SHARDED_PARAMS:
            return (None,) * (tree.dim() - 1) + ("model",)
        return ()
    return walk(params)


def is_sharded(x) -> bool:
    """True for a per-shard list (or tuple) of tensors."""
    return isinstance(x, (list, tuple))


def shard_tensor(t: torch.Tensor, axis: int, n_shards: int,
                 devices: Sequence[torch.device] = ()) -> List[torch.Tensor]:
    """``t`` cut into ``n_shards`` equal pieces along ``axis``, each a
    contiguous tensor of its own on its shard's device (``devices``, by
    default ``t``'s)."""
    if t.shape[axis] % n_shards:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} does not divide "
                         f"into {n_shards} shards")
    devices = list(devices) or [t.device] * n_shards
    return [p.to(d).contiguous()
            for p, d in zip(torch.chunk(t, n_shards, dim=axis), devices)]


def unshard(parts: Sequence[torch.Tensor], axis: int) -> torch.Tensor:
    """The per-shard pieces concatenated along ``axis`` in shard order
    (the reference's tiled all-gather), on the first shard's device; one
    piece as it is (no copy)."""
    if len(parts) == 1:
        return parts[0]
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=axis)


def shard_params(params: Dict, mesh) -> List[Dict]:
    """The per-shard parameter trees of ``params`` on ``mesh``: each
    sharded leaf (``serving_param_pspecs``) cut along its last axis into
    the shard's contiguous slice on the shard's device; each replicated
    leaf held once per distinct device (the same tensor in every tree of
    shards that share a device), so shards on one device cost no weight
    memory beyond the sliced projections."""
    specs = serving_param_pspecs(params)
    n = mesh.n_shards
    placed: Dict[tuple, torch.Tensor] = {}

    def replicated(t, dev):
        key = (id(t), dev)
        if key not in placed:
            placed[key] = t.to(dev)
        return placed[key]

    def walk(tree, spec):
        if isinstance(tree, dict):
            subs = {k: walk(v, spec[k]) for k, v in tree.items()}
            return [{k: subs[k][s] for k in tree} for s in range(n)]
        if spec:
            return shard_tensor(tree, tree.dim() - 1, n, mesh.shards)
        return [replicated(tree, d) for d in mesh.shards]
    return walk(params, specs)
