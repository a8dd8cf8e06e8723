"""Dry-run case construction: the inputs of every (architecture x input
shape) as shapes with no data, their layouts on a mesh, and the step
function of each kind.

Counterpart of ``repro/launch/specs.py``.  Where the reference builds
``ShapeDtypeStruct`` inputs with ``NamedSharding``s for ``jit``, the port
builds meta tensors (``init_params`` and ``init_caches`` on the ``meta``
device) and lays each out as a DTensor on the mesh's ``DeviceMesh`` over
the fake process group, by the reference's spec rules
(``models/sharding.py``).  Nothing is allocated on any device.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import sharding as shard_rules
from repro_torch.models import steps
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamWState, adamw_init, tree_leaves

META = torch.device("meta")


def supports_case(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """long_500k only runs on sub-quadratic-decode archs (DESIGN.md)."""
    if shape.name == "long_500k" and not cfg.supports_long_context_decode:
        return False, ("skip: pure full-attention arch without a "
                       "windowed/recurrent variant (DESIGN.md long_500k rule)")
    return True, ""


# ---------------------------------------------------------------------------
# inputs: meta tensors
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def _decoder_len(cfg: ModelConfig, shape: InputShape) -> int:
    """The decoder's sequence: bounded by the model's max positions for an
    encoder-decoder model."""
    if cfg.encoder_decoder:
        return min(shape.seq_len, cfg.max_seq_len)
    return shape.seq_len


def _extras(cfg: ModelConfig, B: int) -> Dict[str, torch.Tensor]:
    """The modality inputs: a VLM's (stub) frontend embeddings, an
    encoder-decoder model's encoder frames."""
    extras = {}
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        extras["extra_embeds"] = _meta(
            (B, cfg.frontend.n_tokens, cfg.frontend.d_embed), torch.float32)
    if cfg.encoder_decoder:
        extras["encoder_frames"] = _meta(
            (B, cfg.n_encoder_tokens, cfg.d_model), torch.float32)
    return extras


def train_batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict:
    B, S = shape.global_batch, _decoder_len(cfg, shape)
    return {"tokens": _meta((B, S), torch.int32),
            "labels": _meta((B, S), torch.int32), **_extras(cfg, B)}


def decode_input_specs(cfg: ModelConfig, shape: InputShape, kv_dtype=None):
    """(caches, token (B,), pos ()) as meta tensors; ``kv_dtype``
    ``torch.int8`` for the quantised attention cache."""
    B, S = shape.global_batch, shape.seq_len
    caches = T.init_caches(cfg, B, S, kv_dtype=kv_dtype, device=META)
    return caches, _meta((B,), torch.int32), _meta((), torch.int32)


# ---------------------------------------------------------------------------
# layouts: spec trees (one tuple per leaf, the reference's PartitionSpecs)
# ---------------------------------------------------------------------------

_axsize = shard_rules._axis_size
_fit = shard_rules._fit


def batch_spec(mesh, batch: int, all_axes: bool = False) -> Any:
    """The batch dim's axes.  ``all_axes``: spread the batch over the
    WHOLE mesh (ZeRO-3-style fully data-parallel activations; the params
    stay 2-D sharded and are gathered per layer), the train step's."""
    if all_axes:
        full = tuple(mesh.axis_names)
        if batch % _axsize(mesh, full) == 0:
            return full
    ba = shard_rules.batch_axes(mesh)
    if batch % _axsize(mesh, ba) == 0:
        return ba
    if batch % mesh.shape["data"] == 0:
        return "data"
    return None


def _map(fn, tree):
    """``fn`` over the leaves of nested dicts and (named) tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def train_batch_shardings(cfg, mesh, batch_specs_tree):
    def one(leaf):
        bax = batch_spec(mesh, leaf.shape[0], all_axes=True)
        return (bax,) + (None,) * (leaf.dim() - 1)
    return _map(one, batch_specs_tree)


def cache_shardings(cfg: ModelConfig, mesh, caches_shape,
                    global_batch: int, long_context: bool):
    """Per-leaf decode-cache specs (DESIGN.md §5): the batch over (pod,
    data); for (L, B, S, H, D)-like leaves the sequence over ``model``,
    or over (data, model) at batch 1 (long context); stateful caches
    (SSM / RWKV) by heads over ``model``."""
    bax = batch_spec(mesh, global_batch)

    def leaf_spec(leaf) -> tuple:
        shp = tuple(leaf.shape)
        nd = len(shp)
        spec = [None] * nd
        # the batch dim: the first dim equal to global_batch after any
        # leading stack axes
        b_idx = None
        for i, d in enumerate(shp):
            if d == global_batch and i <= 2:
                b_idx = i
                break
        if b_idx is None:
            return ()
        if bax is not None and global_batch > 1:
            spec[b_idx] = bax
        # the sequence dim: the first large dim (>= 256) after the batch
        s_idx = None
        for i in range(b_idx + 1, nd - 1):
            if shp[i] >= 256:
                s_idx = i
                break
        if s_idx is not None:
            if long_context:
                ax = _fit(shp[s_idx], mesh, ("data", "model"))
                spec[s_idx] = ax if ax else _fit(shp[s_idx], mesh, "model")
            else:
                spec[s_idx] = _fit(shp[s_idx], mesh, "model")
        else:
            # stateful caches (SSM/RWKV): heads over model
            for i in range(b_idx + 1, nd):
                if shp[i] >= 8 and shp[i] % mesh.shape["model"] == 0:
                    spec[i] = "model"
                    break
        return tuple(spec)

    return _map(leaf_spec, caches_shape)


def activation_ctx_for(cfg: ModelConfig, shape: InputShape, mesh,
                       variants=()):
    """Activation context of the trace (DESIGN.md §5): train puts the
    batch over ALL axes (ZeRO-3: the params gathered per layer);
    prefill / decode the batch over (pod, data), K/V's sequence over
    model."""
    cap = "moe-cap-shard" in variants
    if shape.kind == "train":
        bax = batch_spec(mesh, shape.global_batch, all_axes=True)
        return shard_rules.ActivationCtx(mesh=mesh, batch_axes=bax,
                                         kv_seq_axis=None, moe_cap_shard=cap)
    bax = batch_spec(mesh, shape.global_batch)
    return shard_rules.ActivationCtx(mesh=mesh, batch_axes=bax,
                                     kv_seq_axis="model", moe_cap_shard=cap)


def _with_act_ctx(fn, ctx):
    """``fn`` with the activation context set while it runs."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        tok = shard_rules.set_activation_ctx(ctx)
        try:
            return fn(*args, **kw)
        finally:
            shard_rules.reset_activation_ctx(tok)
    return wrapped


# ---------------------------------------------------------------------------
# DTensors
# ---------------------------------------------------------------------------

def distribute(tree, specs, mesh):
    """The meta tensors of ``tree`` laid out on ``mesh`` by the matching
    spec tree: each a DTensor whose local shard is a meta tensor of
    ``sharding.local_shape``."""
    from torch.distributed.tensor import DTensor

    flat_specs = iter(_spec_leaves(specs))

    def one(t):
        spec = next(flat_specs)
        local = _meta(shard_rules.local_shape(t.shape, spec, mesh), t.dtype)
        return DTensor.from_local(
            local, mesh.device_mesh, shard_rules.placements(spec, mesh),
            run_check=False, shape=t.shape, stride=t.stride())

    out = _map(one, tree)
    if next(flat_specs, None) is not None:
        raise ValueError("the spec tree has more leaves than the tree")
    return out


def _spec_leaves(specs) -> list:
    """The spec tuples of a spec tree, in ``tree_leaves`` order."""
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return [s for v in specs for s in _spec_leaves(v)]
    if isinstance(specs, list):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


def local_tensors(tree) -> list:
    """The tensors one device holds of a tree of DTensors (and plain
    tensors; other leaves are left out)."""
    from torch.distributed.tensor import DTensor
    out = []
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            out.append(t)
    return out


def local_bytes(tree) -> int:
    """Bytes one device holds of a tree of DTensors (and plain tensors)."""
    return sum(t.numel() * t.element_size() for t in local_tensors(tree))


# ---------------------------------------------------------------------------
# case assembly
# ---------------------------------------------------------------------------

def build_case(cfg: ModelConfig, shape: InputShape, mesh,
               variant: str = "baseline") -> Dict[str, Any]:
    """Returns dict(fn, args (trees of DTensors over meta shards), specs
    (their spec trees)); ``fn(*args)`` runs the step.

    Variants ('+'-combinable, e.g. "tp-params+kv-int8"):
      * "tp-params": pure tensor-parallel params (no data-axis ZeRO
        shard), which removes the per-step weight all-gather of decode;
      * "kv-int8": the int8 attention KV cache, which halves the
        memory-bound decode's dominant HBM term;
      * "moe-cap-shard": MoE dispatch capacity over ``data``, which
        removes the data-axis replication of the expert products.
    """
    variants = set(variant.split("+")) if variant else {"baseline"}
    known = {"baseline", "tp-params", "kv-int8", "moe-cap-shard"}
    if not variants <= known:
        raise ValueError(f"unknown variant(s) {sorted(variants - known)}; "
                         f"known: {sorted(known)}")
    params_shape = T.init_params(cfg, device=META)
    pshard = shard_rules.param_shardings(
        cfg, mesh, params_shape, replicate_data="tp-params" in variants)
    act_ctx = activation_ctx_for(cfg, shape, mesh, variants=variants)

    if shape.kind == "train":
        opt_shape = adamw_init(params_shape)
        # the moments share the params' specs; the step is replicated
        opt_shard = AdamWState(step=(), mu=pshard, nu=pshard)
        batch = train_batch_specs(cfg, shape)
        bshard = train_batch_shardings(cfg, mesh, batch)
        fn = _with_act_ctx(functools.partial(steps.train_step, cfg=cfg),
                           act_ctx)
        shapes, specs = (params_shape, opt_shape, batch), (pshard, opt_shard,
                                                           bshard)
    elif shape.kind == "prefill":
        B, S = shape.global_batch, _decoder_len(cfg, shape)
        bax = batch_spec(mesh, B)
        extras = _extras(cfg, B)

        def fn(params, tokens, extras):
            return steps.prefill(params, cfg, tokens, **extras)

        fn = _with_act_ctx(fn, act_ctx)
        shapes = (params_shape, _meta((B, S), torch.int32), extras)
        specs = (pshard, (bax, None), {k: (bax, None, None) for k in extras})
    else:
        S = _decoder_len(cfg, shape)
        eff_shape = shape if S == shape.seq_len else InputShape(
            shape.name, S, shape.global_batch, shape.kind)
        caches, token, pos = decode_input_specs(
            cfg, eff_shape,
            kv_dtype=torch.int8 if "kv-int8" in variants else None)
        cshard = cache_shardings(cfg, mesh, caches, shape.global_batch,
                                 long_context=shape.global_batch == 1)
        bax = batch_spec(mesh, shape.global_batch)
        fn = _with_act_ctx(functools.partial(steps.serve_step, cfg=cfg),
                           act_ctx)
        shapes = (params_shape, caches, token, pos)
        specs = (pshard, cshard, (bax,), ())
    args = tuple(distribute(t, s, mesh) for t, s in zip(shapes, specs))
    return dict(fn=fn, args=args, specs=specs)
