"""Sharding rules: the serving half's head-sharded tensor-parallel
layout, and (below) the dry-run half's 2-D layout of a production mesh.

The serving half is the counterpart of
``repro/models/sharding.py:180-232``.  The serving layout shards
output-channel dims only: the q/k/v projections' columns (the
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

import contextvars
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

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


# ---------------------------------------------------------------------------
# The dry-run half: 2-D parameter, batch and cache specs on a production
# mesh, and the activation constraints the layers anchor at trace time
# ---------------------------------------------------------------------------
# Counterpart of ``repro/models/sharding.py:27-166,238-302``, rule for
# rule.  The scheme: tensor parallel over ``model`` (attention heads
# through the fused head dim, the FFN hidden dim, MoE experts, the
# vocabulary); ZeRO-style over ``data`` for the other matrix dim,
# replicated where it does not divide; the batch over (``pod``,
# ``data``).  A mesh here is anything with ``axis_names`` and ``shape``
# (a name -> size mapping): ``launch.mesh.MeshShape`` or the production
# meshes.  A spec is a tuple with one entry per tensor axis: None, an
# axis name, or a tuple of axis names (the reference's PartitionSpec
# entries); ``placements`` turns it into DTensor placements.


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= mesh.shape[n]
        return out
    return mesh.shape[name]


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _fit(dim: int, mesh, axis):
    """``axis`` where ``dim`` divides by its size, else None."""
    return axis if dim % _axis_size(mesh, axis) == 0 else None


def param_spec(path: str, shape, cfg, mesh) -> tuple:
    """The reference's name-based rule for the leaf at ``path`` ('/'-joined
    keys) of shape ``shape``; leading (stacked layer) axes stay None."""
    shape = tuple(shape)
    nd = len(shape)

    def spec(*trailing):
        return (None,) * (nd - len(trailing)) + tuple(trailing)

    # 1-D (norm scales, biases) and narrow leaves: replicated
    if nd == 0 or shape[-1] <= 8:
        return ()
    name = path.split("/")[-1]

    # embedding / LM head (V, d): vocab over model, d over data
    if name == "table":
        return spec(_fit(shape[-2], mesh, "model"),
                    _fit(shape[-1], mesh, "data"))
    if path.endswith("mm_proj/w"):
        return spec(_fit(shape[-2], mesh, "data"), None)

    # MoE experts (..., E, d, f) / (..., E, f, d): experts over model
    if (cfg.moe is not None and name in ("w_gate", "w_up", "w_down")
            and nd >= 3 and shape[-3] == cfg.moe.n_experts):
        return spec(_fit(shape[-3], mesh, "model"),
                    _fit(shape[-2], mesh, "data"), None)
    if name == "router":
        return spec(_fit(shape[-2], mesh, "data"), None)

    # attention: the output dim (heads * hd) over model, the input over data
    if name in ("wq", "wk", "wv", "w_uq", "w_uk", "w_uv", "w_krope",
                "w_dq", "w_dkv"):
        return spec(_fit(shape[-2], mesh, "data"),
                    _fit(shape[-1], mesh, "model"))
    if name in ("wo", "w_o", "w_out"):
        return spec(_fit(shape[-2], mesh, "model"),
                    _fit(shape[-1], mesh, "data"))
    if name in ("bq", "bk", "bv"):
        return spec(_fit(shape[-1], mesh, "model"))

    # dense MLP: the hidden dim over model
    if name in ("w_gate", "w_up", "w_in"):
        return spec(_fit(shape[-2], mesh, "data"),
                    _fit(shape[-1], mesh, "model"))
    if name == "w_down":
        return spec(_fit(shape[-2], mesh, "model"),
                    _fit(shape[-1], mesh, "data"))
    if name in ("b_in",):
        return spec(_fit(shape[-1], mesh, "model"))
    if name in ("b_out", "b_out_mlp"):
        return spec()

    # RWKV mixing matrices, mamba in-projection: data x model
    if name in ("w_r", "w_k", "w_v", "w_g", "cm_wr", "cm_wk", "w_in_rwkv",
                "lora_A", "decay_lora_A"):
        return spec(_fit(shape[-2], mesh, "data"),
                    _fit(shape[-1], mesh, "model"))
    if name in ("cm_wv",):
        return spec(_fit(shape[-2], mesh, "model"),
                    _fit(shape[-1], mesh, "data"))

    # any other 2-D+ weight: the two trailing dims data x model
    if nd >= 2 and min(shape[-1], shape[-2]) >= 64:
        return spec(_fit(shape[-2], mesh, "data"),
                    _fit(shape[-1], mesh, "model"))
    return ()


def _drop_data(spec: tuple) -> tuple:
    """``spec`` without the ``data`` axis (pure tensor parallelism)."""
    out = []
    for ax in spec:
        if ax == "data":
            out.append(None)
        elif isinstance(ax, tuple):
            out.append(tuple(a for a in ax if a != "data") or None)
        else:
            out.append(ax)
    return tuple(out)


def param_shardings(cfg, mesh, params, replicate_data: bool = False):
    """The spec tree of ``params`` (nested dicts of tensors or shapes).
    ``replicate_data`` drops the ZeRO-style ``data`` sharding (the
    ``tp-params`` variant)."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        spec = param_spec(path, tree.shape, cfg, mesh)
        return _drop_data(spec) if replicate_data else spec
    return walk(params, "")


def tokens_spec(mesh, batch: int) -> tuple:
    ba = batch_axes(mesh)
    if batch % _axis_size(mesh, ba) == 0:
        return (ba,)
    if batch % _axis_size(mesh, "data") == 0:
        return ("data",)
    return ()


def cache_spec(cfg, mesh, batch: int, leaf_ndim: int, *,
               seq_axis: Optional[int] = None,
               heads_axis: Optional[int] = None,
               long_context: bool = False) -> tuple:
    """Spec of an (L, B, S, H, D)-like cache leaf: B over (pod, data), H
    over model; at batch 1 with ``long_context``, S over data."""
    spec = [None] * leaf_ndim
    ba = batch_axes(mesh)
    if batch % _axis_size(mesh, ba) == 0:
        spec[1] = ba
    elif batch % _axis_size(mesh, "data") == 0:
        spec[1] = "data"
    elif long_context and seq_axis is not None:
        spec[seq_axis] = "data"
    if heads_axis is not None:
        spec[heads_axis] = "model"
    return tuple(spec)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh axis,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names it (a tuple
    entry splits its dim over its axes major to minor, which is mesh
    order for every spec these rules make), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.axis_names:
        dim = next((d for d, ax in enumerate(spec)
                    if ax == name or (isinstance(ax, tuple) and name in ax)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape one device holds of a ``shape`` tensor laid out by
    ``spec`` (every dim a spec shards divides by its axes' size)."""
    shape = list(shape)
    for d, ax in enumerate(spec):
        shape[d] //= _axis_size(mesh, ax)
    return tuple(shape)


class ActivationCtx(NamedTuple):
    mesh: Any
    batch_axes: Any                 # the axes of activations' batch dim
    kv_seq_axis: Optional[str]      # the axis of K/V's sequence dim
    moe_cap_shard: bool = False     # MoE capacity over data as well


_ACT_CTX: "contextvars.ContextVar[Optional[ActivationCtx]]" = \
    contextvars.ContextVar("repro_torch_activation_sharding", default=None)


def set_activation_ctx(ctx: Optional[ActivationCtx]):
    return _ACT_CTX.set(ctx)


def reset_activation_ctx(token) -> None:
    _ACT_CTX.reset(token)


def _constrain(x, spec):
    """``x`` redistributed to ``spec`` on the context's mesh."""
    mesh = _ACT_CTX.get().mesh
    return x.redistribute(mesh.device_mesh, placements(spec, mesh))


def _active(x):
    """The context where it is set and ``x`` is a DTensor, else None:
    without both every ``constrain_*`` returns its input unchanged."""
    ctx = _ACT_CTX.get()
    if ctx is None or x is None:
        return None
    from torch.distributed.tensor import DTensor
    return ctx if isinstance(x, DTensor) else None


def constrain_batch(x, batch_dim: int = 0):
    """Anchor an activation's batch dim to the context's batch axes."""
    ctx = _active(x)
    if ctx is None:
        return x
    if x.shape[batch_dim] % _axis_size(ctx.mesh, ctx.batch_axes) != 0:
        return x
    spec = [None] * x.dim()
    spec[batch_dim] = ctx.batch_axes
    return _constrain(x, tuple(spec))


def constrain_kv_seq(x, seq_dim: int = 1, batch_dim: int = 0):
    """Anchor K/V (B, S, H, D) with the sequence dim over kv_seq_axis."""
    ctx = _active(x)
    if ctx is None or ctx.kv_seq_axis is None:
        return x
    spec = [None] * x.dim()
    if x.shape[batch_dim] % _axis_size(ctx.mesh, ctx.batch_axes) == 0:
        spec[batch_dim] = ctx.batch_axes
    if x.shape[seq_dim] % _axis_size(ctx.mesh, ctx.kv_seq_axis) == 0:
        spec[seq_dim] = ctx.kv_seq_axis
    return _constrain(x, tuple(spec))


def constrain_experts(x, expert_dim: int = 0):
    """Anchor an (E, C, d) MoE buffer expert-parallel over ``model``; with
    ``moe_cap_shard`` the capacity dim over ``data`` as well (without it
    the expert products are replicated over the data axis)."""
    ctx = _active(x)
    if ctx is None:
        return x
    if x.shape[expert_dim] % ctx.mesh.shape["model"] != 0:
        return x
    spec = [None] * x.dim()
    spec[expert_dim] = "model"
    if (ctx.moe_cap_shard and x.dim() > expert_dim + 1
            and x.shape[expert_dim + 1] % ctx.mesh.shape["data"] == 0):
        spec[expert_dim + 1] = "data"
    return _constrain(x, tuple(spec))
