"""Roofline analysis of one traced dry-run step, on the H100's peaks.

Counterpart of ``repro/roofline/analysis.py``.  Three terms per (arch x
shape x mesh), each a per-device time:

    compute    = flops per device / PEAK_FLOPS
    memory     = bytes per device / HBM_BW
    collective = sum over collectives of their bytes / the link rate of
                 their mesh axis

Where the reference reads flops and bytes from the compiled program's
``cost_analysis()`` and parses collectives out of its optimised HLO, the
port traces one step over DTensors on a fake process group
(``launch/specs.py``) under ``TraceCounter``: a dispatch mode that sees
every operation DTensor runs on one device's local shards, so what it
counts is one device's work, replicated work included, and every
collective DTensor issues, once, by its result's bytes.  Its flops are
those of the products (``torch.utils.flop_counter``'s formulas: matrix
products and attention; XLA's count adds the elementwise work), its
bytes each local operation's inputs and outputs (XLA's "bytes accessed"
without fusion).  As in the reference, analytic floors floor both counts
and ``flops_source`` / ``bytes_source`` say which won.

Hardware constants are the published peaks of an H100 SXM, not
measurements.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# H100 SXM5 datasheet: 989 TFLOP/s dense bf16 tensor-core, 3.35 TB/s HBM3
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
# NVLink 4 (18 links x 25 GB/s a direction): 450 GB/s a direction between
# GPUs of one 8-GPU HGX node
NVLINK_BW = 450e9
# NDR InfiniBand, one 400 Gb/s adapter per GPU: 50 GB/s a direction
IB_BW = 50e9
GPUS_PER_NODE = 8

_COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                   "all-to-all", "collective-permute")

# the functional collectives DTensor issues, by op name
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional",
                          "_dtensor")
# bookkeeping operations that move no bytes
_FREE_OPS = {"detach", "empty", "empty_strided", "empty_like", "lift_fresh",
             "_wrap_tensor_autograd", "wait_tensor", "_local_scalar_dense",
             "alias", "set_", "_to_copy_meta", "zeros_like_meta"}


def _leaves(x, out: list) -> list:
    """The leaves of nested tuples, lists and dicts (an operation's
    arguments), appended to ``out`` in order."""
    if isinstance(x, (tuple, list)):
        for v in x:
            _leaves(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _leaves(v, out)
    else:
        out.append(x)
    return out


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes an operation reads of ``t``: its elements, or its storage
    where that is smaller (a broadcast view reads its source once)."""
    return min(_tensor_bytes(t), t.untyped_storage().nbytes())


def link_bw(mesh, axis: str, gpus_per_node: int = GPUS_PER_NODE) -> float:
    """The link rate of a collective over ``axis`` of ``mesh`` laid out
    row-major over consecutive GPUs: NVLink where every group of the axis
    sits inside one node, InfiniBand where one crosses nodes."""
    names, sizes = list(mesh.axis_names), list(mesh.sizes)
    i = names.index(axis)
    stride = math.prod(sizes[i + 1:])
    span = stride * (sizes[i] - 1) + 1          # ranks a group spans
    inside = all(
        (r0 // gpus_per_node) == ((r0 + span - 1) // gpus_per_node)
        for r0 in range(0, math.prod(sizes))
        if (r0 // stride) % sizes[i] == 0)
    return NVLINK_BW if inside else IB_BW


class TraceCounter(TorchDispatchMode):
    """Counts what one device of ``mesh`` runs in a step traced over
    DTensors.

    An operation on DTensors runs through DTensor's dispatch with this
    mode beneath it (``_dtensor_op``: replayed from a memo where one of
    the same signature ran before, with fallbacks where DTensor cannot
    shard it), so the mode sees the operations on the local shards; the
    operations DTensor runs on fake tensors of the global shapes to
    propagate shapes are passed through uncounted.  On the local
    operations it counts: the flops of the products, the bytes each
    non-view operation reads and writes, each functional collective by
    kind (its result's bytes, its mesh axis), the live bytes of the
    storages the trace allocates (the peak beyond
    ``register_arguments``' storages) and which arguments it read."""

    def __init__(self, mesh):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.mesh = mesh
        self.flops = 0.0
        self.bytes = 0.0
        self.collective_bytes: Dict[str, int] = {k: 0 for k in
                                                 _COLLECTIVE_OPS}
        self.collective_counts: Dict[str, int] = {k: 0 for k in
                                                  _COLLECTIVE_OPS}
        self.collective_s = 0.0
        self.ops = 0
        self._group_axis = {mesh.device_mesh.get_group(i).group_name: name
                            for i, name in enumerate(mesh.axis_names)}
        self._known: Dict[int, int] = {}      # storage key -> bytes
        self._refs = {}
        self.live = 0
        self.peak = 0
        self.fallbacks: Dict[str, int] = {}
        self.decomposed: Dict[str, int] = {}
        self._in_dtensor = False
        self._memo: Dict = {}
        self._seen = set()
        self._args = set()           # argument storages
        self._read = set()           # ... that an operation read
        self._read_log = []          # every such read, in order

    # ---- memory -----------------------------------------------------------
    def register_arguments(self, tensors) -> None:
        """Mark the storages of ``tensors`` (local shards) as arguments:
        neither counted as live nor freed, and each noted when an
        operation first reads it (``argument_read``)."""
        for t in tensors:
            key = t.untyped_storage()._cdata
            self._known.setdefault(key, 0)
            self._args.add(key)

    def argument_read(self, t: torch.Tensor) -> bool:
        """Whether the step read the argument shard ``t``: the
        counterpart of XLA keeping an argument (``jit`` drops the unused
        ones, and its argument bytes leave them out)."""
        return t.untyped_storage()._cdata in self._read

    def _note_reads(self, tensors) -> None:
        for t in tensors:
            key = t.untyped_storage()._cdata
            if key in self._args:
                self._read.add(key)
                self._read_log.append(key)

    def _track(self, t: torch.Tensor, nbytes: Optional[int] = None) -> None:
        """Count ``t``'s storage live until it is freed (as ``nbytes``
        where given: a replayed output standing for its recorded
        storage)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known:
            return
        n = st.nbytes() if nbytes is None else nbytes
        self._known[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)

        def free(_, key=key):
            self.live -= self._known.pop(key, 0)
            self._refs.pop(key, None)
        self._refs[key] = weakref.ref(st, free)

    # ---- dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat_in = _leaves(args, [])
        _leaves(kwargs, flat_in)
        if any(isinstance(a, DTensor) for a in flat_in):
            if self._in_dtensor:
                return NotImplemented          # DTensor's own dispatch
            return self._dtensor_op(func, args, kwargs, flat_in)
        out = func(*args, **kwargs)
        if _PROPAGATING[0] or any(isinstance(a, FakeTensor)
                                  for a in flat_in):
            return out                        # DTensor's shape propagation
        self.ops += 1
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        flat_out, _ = tree_flatten(out)
        outs = [o for o in flat_out if isinstance(o, torch.Tensor)]
        ins = [a for a in flat_in if isinstance(a, torch.Tensor)]
        if not (func.is_view or name in _FREE_OPS):
            self._note_reads(ins)
        if ns in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVE_KIND.get(name)
            if kind is not None:
                nbytes = sum(_tensor_bytes(o) for o in outs)
                self.collective_bytes[kind] += nbytes
                self.collective_counts[kind] += 1
                self.collective_s += nbytes / self._link(args, kwargs)
            for o in outs:
                self._track(o)
            return out
        if func._overloadpacket in self._flop_registry:
            self.flops += self._flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        if func.is_view or name in _FREE_OPS:
            return out
        self.bytes += sum(_read_bytes(a) for a in ins)
        self.bytes += sum(_tensor_bytes(o) for o in outs)
        for o in outs:
            self._track(o)
        return out

    def _dtensor_op(self, func, args, kwargs, flat_in):
        """A DTensor operation: replayed from ``_memo`` where one of the
        same signature ran twice before, else run (``_run_dtensor_op``)
        and, on its second run, its effects recorded.  Every operation
        on meta shards is a function of its inputs' shapes, dtypes and
        placements, so a repeated layer or chunk costs a lookup, not
        DTensor's dispatch."""
        key = None
        if not func._schema.is_mutable:
            try:
                key = (func, _signature(args, self._args),
                       _signature(kwargs, self._args))
                hash(key)
            except TypeError:
                key = None
        if key is not None and key in self._memo:
            return self._replay(self._memo[key], flat_in)
        # an operation's first run may differ from its later ones (DTensor
        # plans and caches on first sight), so the second run is recorded
        record = key is not None and key in self._seen
        if key is not None:
            self._seen.add(key)
        before = self._snapshot()
        n_reads = len(self._read_log)
        saved_peak, self.peak = self.peak, self.live
        try:
            out = self._run_dtensor_op(func, args, kwargs)
        finally:
            call_peak = self.peak
            self.peak = max(saved_peak, call_peak)
        if record:
            memo = _record(out, flat_in, before, self._snapshot(),
                           call_peak - before["live"],
                           set(self._read_log[n_reads:]))
            if memo is not None:
                self._memo[key] = memo
        return out

    def _snapshot(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes, "ops": self.ops,
                "collective_s": self.collective_s, "live": self.live,
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts),
                "fallbacks": dict(self.fallbacks),
                "decomposed": dict(self.decomposed)}

    def _replay(self, memo, flat_in):
        """The effects of a recorded operation, again: its counts, its
        transient peak, and outputs of its recorded specs (new meta
        shards; an output that was one of the inputs is that input)."""
        d = memo["delta"]
        self.flops += d["flops"]
        self.bytes += d["bytes"]
        self.ops += d["ops"]
        self.collective_s += d["collective_s"]
        for name in ("collective_bytes", "collective_counts", "fallbacks",
                     "decomposed"):
            tgt = getattr(self, name)
            for k, v in d[name].items():
                tgt[k] = tgt.get(k, 0) + v
        self.peak = max(self.peak, self.live + memo["peak_rel"])
        self._note_reads(flat_in[i]._local_tensor for i in memo["reads"])
        outs = []
        for kind, val in memo["outs"]:
            if kind == "input":
                outs.append(flat_in[val])
            elif kind == "dtensor":
                spec, lshape, lstride, dtype, new, alias = val
                if alias is not None:
                    base = flat_in[alias[0]]._local_tensor
                    local = torch.as_strided(
                        base, lshape, lstride,
                        base.storage_offset() + alias[1])
                else:
                    local = torch.empty_strided(lshape, lstride, dtype=dtype,
                                                device="meta")
                if new:
                    self._track(local, new)
                outs.append(DTensor(local, spec, requires_grad=False))
            else:
                outs.append(val)
        return memo["treespec"].unflatten(outs) if memo["treespec"] \
            is not None else outs[0]

    def _run_dtensor_op(self, func, args, kwargs):
        """Run a DTensor operation through DTensor's dispatch with this
        mode active beneath it.  Where DTensor has no sharding for the
        operation at its inputs' placements (no strategy, or a shape it
        cannot split: 12 heads over a 16-way axis), the inputs are
        replicated over one mesh axis at a time, the last first, then
        over all of them, until it has one, and where none has, the
        operation runs on the replicated local tensors
        (``_run_replicated``); the gathers are counted like any
        collective (GSPMD's "involuntary full rematerialization") and the
        operation in ``fallbacks``."""
        args = _wrap_inplace_target(func, args)
        self._in_dtensor = True
        try:
            with self:
                decomp = _sharded_dim_decomposition(func, args)
                if decomp is not None:
                    self._in_dtensor = False
                    self.decomposed[str(func)] = (
                        self.decomposed.get(str(func), 0) + 1)
                    return decomp(*args)
                try:
                    return func(*args, **kwargs)
                except Exception as e:  # noqa: BLE001
                    if not _is_sharding_failure(e):
                        raise
                n = len(self.mesh.axis_names)
                for axes in [(i,) for i in reversed(range(n))] + [
                        tuple(range(n))]:
                    a2, k2 = _replicate_axes((args, kwargs), axes)
                    try:
                        out = func(*a2, **k2)
                    except Exception as e:  # noqa: BLE001
                        if not _is_sharding_failure(e):
                            raise
                        continue
                    key = f"{func}: replicate " + ",".join(
                        self.mesh.axis_names[i] for i in axes)
                    self.fallbacks[key] = self.fallbacks.get(key, 0) + 1
                    return out
                # no strategy at any layout: the operation on the
                # replicated inputs' local tensors, its outputs replicated
                out = _run_replicated(func, args, kwargs, n)
                key = f"{func}: run replicated"
                self.fallbacks[key] = self.fallbacks.get(key, 0) + 1
                return out
        finally:
            self._in_dtensor = False

    def _link(self, args, kwargs) -> float:
        """The link rate of a collective's mesh axis, by its group name
        (the slowest rate where the group is not one of the mesh's)."""
        names = [a for a in list(args) + list(kwargs.values())
                 if isinstance(a, str)]
        for n in names:
            axis = self._group_axis.get(n)
            if axis is not None:
                return link_bw(self.mesh, axis)
        return IB_BW


def _signature(x, arg_storages):
    """A hashable stand-in for an operation's arguments: a tensor by its
    shape, strides, dtype (and a DTensor's placements and mesh, and
    whether its shard is one of ``arg_storages``: reading an argument is
    part of what a replay repeats), other values as they are.  Raises
    ``TypeError`` for an unhashable value."""
    if isinstance(x, DTensor):
        return ("D", tuple(x.shape), x.stride(), x.dtype, x.placements,
                id(x.device_mesh),
                x._local_tensor.untyped_storage()._cdata in arg_storages)
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_signature(v, arg_storages)
                                           for v in x)
    if isinstance(x, dict):
        return ("dict",) + tuple((k, _signature(v, arg_storages))
                                 for k, v in sorted(x.items()))
    hash(x)
    return x


def _record(out, flat_in, before, after, peak_rel, read):
    """What replaying an operation needs: the counts it added, its
    transient peak above the live bytes it started at, its outputs'
    specs (or the input an output is), and which of its inputs are
    arguments it read (``read``: the storages it read).  None where an
    output is neither a DTensor, an input nor a plain value."""
    flat_out, treespec = tree_flatten(out)
    # storages the outputs may alias: the inputs' (by index), then each
    # new one once
    inputs = {a._local_tensor.untyped_storage()._cdata: i
              for i, a in enumerate(flat_in) if isinstance(a, DTensor)}
    seen = set()
    outs = []
    for o in flat_out:
        idx = next((i for i, a in enumerate(flat_in) if a is o), None)
        if idx is not None:
            outs.append(("input", idx))
        elif isinstance(o, DTensor):
            local = o._local_tensor
            st = local.untyped_storage()
            if st._cdata in inputs:
                # a view of an input's shard: replayed as a view of the
                # replay's input at the same offset from it
                i = inputs[st._cdata]
                alias = (i, local.storage_offset()
                         - flat_in[i]._local_tensor.storage_offset())
                new = 0
            else:
                alias = None
                new = st.nbytes() if st._cdata not in seen else 0
                seen.add(st._cdata)
            outs.append(("dtensor", (o._spec, tuple(local.shape),
                                     local.stride(), local.dtype, new,
                                     alias)))
        elif isinstance(o, torch.Tensor):
            return None
        else:
            outs.append(("value", o))
    delta = {k: after[k] - before[k] for k in ("flops", "bytes", "ops",
                                                 "collective_s")}
    for name in ("collective_bytes", "collective_counts", "fallbacks",
                 "decomposed"):
        delta[name] = {k: v - before[name].get(k, 0)
                       for k, v in after[name].items()
                       if v != before[name].get(k, 0)}
    single = not isinstance(out, (list, tuple))
    reads = [i for i, a in enumerate(flat_in) if isinstance(a, DTensor)
             and a._local_tensor.untyped_storage()._cdata in read]
    return {"delta": delta, "peak_rel": peak_rel, "outs": outs,
            "treespec": None if single else treespec, "reads": reads}


def _is_sharding_failure(e: Exception) -> bool:
    """True where DTensor could not shard an operation (its refusal, or a
    fault of its own planner, raised inside ``torch.distributed.tensor``)
    as opposed to a fault of the operation itself."""
    msg = str(e)
    if ("Sharding propagation failed" in msg
            or "does not have a sharding strategy" in msg
            or "unevenly sharded" in msg):
        return True
    tb, last = e.__traceback__, ""
    while tb is not None:
        last = tb.tb_frame.f_code.co_filename
        tb = tb.tb_next
    return "distributed/tensor/" in last.replace("\\", "/")


def _sharded_on(t, dim: int) -> bool:
    from torch.distributed.tensor import DTensor, Shard
    dim = dim % t.dim()
    return isinstance(t, DTensor) and any(
        isinstance(p, Shard) and p.dim == dim for p in t.placements)


def _softmax(x, dim, half_to_float):
    m = torch.amax(x, dim=dim, keepdim=True)
    e = torch.exp(x - m)
    return e / torch.sum(e, dim=dim, keepdim=True)


def _softmax_backward(grad, y, dim, input_dtype):
    return y * (grad - torch.sum(grad * y, dim=dim, keepdim=True))


def _argmax_gathered(x, dim, keepdim=False):
    """argmax along a sharded dim, that dim gathered first (DTensor's
    own handler cannot gather an index over a fake group)."""
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % x.dim()
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in x.placements]
    return torch.argmax(x.redistribute(x.device_mesh, pl), dim, keepdim)


def _vocab_sharded_lookup(table, indices):
    """``table[idx]`` with ``table`` (V, d) sharded by rows: the indices
    gathered (int32, small), each device's lookup into its shard (rows
    outside it read as zeros, as the masked lookup), the output a partial
    sum over the row-sharded axes and sharded by d where the table is.
    DTensor's own masked-partial lookup keeps a mask of the data, which
    meta shards do not have."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    (idx,) = indices
    mesh = table.device_mesh
    if isinstance(idx, DTensor):
        idx = idx.redistribute(mesh, [Replicate()] * mesh.ndim)._local_tensor
    local = table._local_tensor
    out = local[torch.clamp(idx, 0, local.shape[0] - 1)]
    pl = [Partial() if isinstance(p, Shard) and p.dim == 0
          else Shard(idx.dim() + p.dim - 1) if isinstance(p, Shard)
          else Replicate() for p in table.placements]
    shape = (*idx.shape, table.shape[1])
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _sharded_gather(x, dim, index, sparse_grad=False):
    """``torch.gather(x, dim, index)`` along a dim ``x`` shards: ``index``
    laid out as ``x`` on the other dims (replicated where ``x`` shards
    ``dim``), each device's gather from its shard, the output a partial
    sum over the axes that shard ``dim`` (DTensor's own masked partial
    keeps a mask of the data, which meta shards do not have)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    dim = dim % x.dim()
    idx_pl, out_pl = [], []
    for p in x.placements:
        if isinstance(p, Shard) and p.dim == dim:
            idx_pl.append(Replicate())
            out_pl.append(Partial())
        else:
            # a gather of a partial sum is the partial sum of the gathers
            idx_pl.append(p if isinstance(p, Shard) else Replicate())
            out_pl.append(p)
    if isinstance(index, DTensor):
        index = index.redistribute(mesh, idx_pl)._local_tensor
    local = x._local_tensor
    out = torch.gather(local, dim,
                       torch.clamp(index, 0, local.shape[dim] - 1))
    shape = torch.Size(_global_shape(out.shape, out_pl, mesh))
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _local_index_copy(x, dim, index, src):
    """``x.index_copy(dim, index, src)`` (a decode step's cache write) on
    each device's shard of ``x``, whose layout the output keeps: ``src``
    laid out as ``x`` on the other dims and replicated along ``dim``,
    the index gathered and clamped into the shard (the shard that holds
    the row writes it, as XLA's partitioned dynamic-update-slice; on
    meta shards which one does is not seen).  DTensor has no strategy
    for this operation in some versions, and would otherwise gather the
    whole cache."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    dim = dim % x.dim()
    src_pl = [p if isinstance(p, Shard) and p.dim != dim else Replicate()
              for p in x.placements]
    if isinstance(src, DTensor):
        src = src.redistribute(mesh, src_pl)._local_tensor
    if isinstance(index, DTensor):
        index = index.redistribute(mesh, [Replicate()] * mesh.ndim
                                   )._local_tensor
    local = x._local_tensor
    out = local.index_copy(dim, torch.clamp(index, 0, local.shape[dim] - 1),
                           src)
    return DTensor.from_local(out, mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def _global_shape(local_shape, placements, mesh):
    """The global shape of an evenly sharded local shape."""
    from torch.distributed.tensor import Shard
    shape = list(local_shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            shape[p.dim] *= mesh.size(i)
    return shape


def _sharded_dim_decomposition(func, args):
    """Where a softmax (or its backward) runs along a dim its DTensor
    input shards, DTensor would gather the whole input; XLA's SPMD
    partitioner reduces the max and the sum across the shards instead.
    Returns that decomposition (reductions over the sharded dim, which
    DTensor all-reduces) for such a call, else None; and an argmax along
    a sharded dim gathers that dim first.  A lookup into a table sharded
    by rows (the vocab-sharded embedding) is a lookup into each shard
    whose outputs sum (``_vocab_sharded_lookup``), and so is a gather
    along a sharded dim (``_sharded_gather``: the CE's label logits); a
    cache write (``index_copy``) writes each device's shard
    (``_local_index_copy``)."""
    aten = torch.ops.aten
    if func == aten._softmax.default and _sharded_on(args[0], args[1]):
        return _softmax
    if (func == aten.argmax.default and len(args) > 1
            and args[1] is not None and _sharded_on(args[0], args[1])):
        return _argmax_gathered
    if (func == aten._softmax_backward_data.default
            and _sharded_on(args[1], args[2])):
        return _softmax_backward
    if (func == aten.gather.default and isinstance(args[0], DTensor)
            and _sharded_on(args[0], args[1])):
        return _sharded_gather
    if func == aten.index_copy.default and isinstance(args[0], DTensor):
        return _local_index_copy
    if (func == aten.index.Tensor and args[0].dim() == 2
            and _sharded_on(args[0], 0) and len(args[1]) == 1
            and args[1][0] is not None):
        return _vocab_sharded_lookup
    return None


def _wrap_inplace_target(func, args):
    """An in-place operation on a plain tensor with DTensor operands
    (``buf.scatter_(0, index, src)`` where ``buf`` was made by a factory):
    ``args`` with that tensor wrapped as a replicated DTensor, the layout
    implicit replication gives a plain operand, so that DTensor can
    return it."""
    from torch.distributed.tensor import DTensor, Replicate
    if not (func._schema.name.endswith("_") and args
            and isinstance(args[0], torch.Tensor)
            and not isinstance(args[0], DTensor)):
        return args
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    target = DTensor.from_local(args[0], mesh, [Replicate()] * mesh.ndim,
                                run_check=False)
    return (target, *args[1:])


def _run_replicated(func, args, kwargs, n_axes: int):
    """``func`` on the local tensors of its inputs replicated over every
    mesh axis; its tensor outputs as replicated DTensors."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_map
    a2, k2 = _replicate_axes((args, kwargs), tuple(range(n_axes)))
    mesh = next(a.device_mesh for a in tree_flatten((a2, k2))[0]
                if isinstance(a, DTensor))
    a3, k3 = tree_map(lambda t: t._local_tensor if isinstance(t, DTensor)
                      else t, (a2, k2))
    out = func(*a3, **k3)
    return tree_map(lambda t: DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        if isinstance(t, torch.Tensor) else t, out)


def _replicate_axes(tree, axes):
    """``tree`` with every DTensor replicated over the mesh axes
    ``axes`` (their other placements kept)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_map

    def one(t):
        if not isinstance(t, DTensor):
            return t
        pl = [Replicate() if i in axes else p
              for i, p in enumerate(t.placements)]
        return t if pl == list(t.placements) else t.redistribute(
            t.device_mesh, pl)
    return tree_map(one, tree)


# > 0 while DTensor runs an operation on fake tensors of the global shapes
# to find its output's shape: none of that is a device's work
_PROPAGATING = [0]


@contextlib.contextmanager
def dtensor_trace():
    """While tracing: DTensor's shard-to-shard reshuffle issues its
    all-to-all (``_dtensor::shard_dim_alltoall``, whose meta version
    moves nothing) on the CPU mesh too, where it would gather the whole
    tensor and take its chunk, as it does for the gloo backend; and the
    operations DTensor runs to propagate shapes are marked, so that
    ``TraceCounter`` leaves them out."""
    from torch.distributed.tensor import placement_types

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    propagate = ShardingPropagator._propagate_tensor_meta_non_cached

    def propagate_uncounted(self, op_schema):
        _PROPAGATING[0] += 1
        try:
            return propagate(self, op_schema)
        finally:
            _PROPAGATING[0] -= 1

    orig = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = shard_dim_alltoall
    ShardingPropagator._propagate_tensor_meta_non_cached = propagate_uncounted
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate


def collective_bytes_from_trace(counter: TraceCounter) -> Dict[str, int]:
    """The counterpart of the reference's ``collective_bytes_from_hlo``:
    bytes per collective kind (each collective once, by its result), and
    ``_op_counts`` per kind."""
    out: Dict[str, int] = dict(counter.collective_bytes)
    out["_op_counts"] = dict(counter.collective_counts)  # type: ignore
    return out


@dataclass
class RooflineTerms:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    n_chips: int
    collective_breakdown: Dict[str, int] = field(default_factory=dict)
    model_flops: float = 0.0           # 6*N*D analytic
    bytes_per_chip_peak: float = 0.0   # arguments + outputs + temp
    # per-device seconds of the collectives at their axes' link rates;
    # None: all of them at IB_BW
    collective_s: Optional[float] = None

    # flops / hbm_bytes / collective_bytes are PER-DEVICE quantities, so
    # each term is one device's time directly

    @property
    def t_compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective_s(self) -> float:
        if self.collective_s is not None:
            return self.collective_s
        return self.collective_bytes / IB_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute_s, "memory": self.t_memory_s,
                 "collective": self.t_collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS (global) vs total traced flops (per-dev x chips)."""
        total = self.flops * self.n_chips
        return self.model_flops / total if total else 0.0

    def as_dict(self) -> Dict:
        return {
            "flops_source": getattr(self, "flops_source", "trace"),
            "bytes_source": getattr(self, "bytes_source", "trace"),
            "hlo_flops": getattr(self, "hlo_flops", 0.0),
            "hlo_bytes": getattr(self, "hlo_bytes", 0.0),
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "t_compute_s": self.t_compute_s,
            "t_memory_s": self.t_memory_s,
            "t_collective_s": self.t_collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "bytes_per_chip_peak": self.bytes_per_chip_peak,
            "collective_breakdown": {
                k: v for k, v in self.collective_breakdown.items()
                if not k.startswith("_")},
            "n_chips": self.n_chips,
        }


def analyze(counter: TraceCounter, n_chips: int, model_flops: float = 0.0,
            analytic_flops_dev: float = 0.0,
            analytic_bytes_dev: float = 0.0,
            bytes_per_chip_peak: float = 0.0) -> RooflineTerms:
    """The roofline terms of a traced step: the counter's per-device flops
    and bytes, each floored by its analytic estimate (the source that won
    in ``flops_source`` / ``bytes_source``; the traced counts stay in
    ``hlo_flops`` / ``hlo_bytes``, the reference's keys), and its
    collectives."""
    flops, hbm = float(counter.flops), float(counter.bytes)
    flops_src = bytes_src = "trace"
    if analytic_flops_dev > flops:
        flops, flops_src = analytic_flops_dev, "analytic"
    if analytic_bytes_dev > hbm:
        hbm, bytes_src = analytic_bytes_dev, "analytic"
    coll = collective_bytes_from_trace(counter)
    coll_total = sum(v for k, v in coll.items() if not k.startswith("_"))
    t = RooflineTerms(flops=flops, hbm_bytes=hbm,
                      collective_bytes=coll_total, n_chips=n_chips,
                      collective_breakdown=coll, model_flops=model_flops,
                      bytes_per_chip_peak=bytes_per_chip_peak,
                      collective_s=counter.collective_s)
    t.flops_source = flops_src        # type: ignore[attr-defined]
    t.bytes_source = bytes_src        # type: ignore[attr-defined]
    t.hlo_flops = float(counter.flops)    # type: ignore[attr-defined]
    t.hlo_bytes = float(counter.bytes)    # type: ignore[attr-defined]
    return t


def _attn_context(cfg, S: int):
    """Per-layer (context_len, n_layers) pairs for attention-flops floors,
    respecting sliding windows / hybrid patterns / recurrent blocks."""
    lp = cfg.layer_pattern
    if lp == "rwkv":
        # linear recurrence: state ops, no context scan
        return [(0, cfg.n_layers)]
    if lp.startswith("local_global"):
        r = int(lp.split(":")[1])
        period = r + 1
        n_glob = cfg.n_layers // period
        w = min(cfg.sliding_window or S, S)
        return [(w, cfg.n_layers - n_glob), (S, n_glob)]
    if lp == "zamba2":
        n_attn = cfg.n_layers // cfg.hybrid_attn_every
        return [(S, n_attn), (0, cfg.n_layers - n_attn)]
    return [(S, cfg.n_layers)]


def _leaf_numels(tree):
    from repro_torch.train.optimizer import tree_leaves
    return [math.prod(t.shape) if t.shape else 1 for t in tree_leaves(tree)]


def analytic_floors(cfg, shape, n_chips: int):
    """Per-device (flops, hbm_bytes) lower-bound estimates that floor the
    traced counts.  Matmul flops from active params; attention context
    per the layer pattern; HBM traffic from param/optimizer reads +
    activation/KV movement."""
    from repro_torch.models.params import count_params_analytic
    n_act = count_params_analytic(cfg, active_only=True)
    B = shape.global_batch
    S = min(shape.seq_len, cfg.max_seq_len) if cfg.encoder_decoder \
        else shape.seq_len
    Hq, hd, d, L = cfg.n_heads, cfg.resolved_head_dim, cfg.d_model, cfg.n_layers

    if shape.kind == "train":
        tokens = B * S
        if cfg.encoder_decoder:
            n_enc, n_dec = _encdec_param_split(cfg)
            flops = 6.0 * (n_enc * B * cfg.n_encoder_tokens
                           + n_dec * tokens)
        else:
            flops = 6.0 * n_act * tokens
        for ctx, nl in _attn_context(cfg, S):
            # fwd 2*B*S*ctx*Hq*hd (QK+AV, causal/2) x3 for backward
            flops += 3.0 * 2.0 * B * S * max(ctx, 1) / 2 * Hq * hd * nl \
                if ctx else 3.0 * 2.0 * B * S * Hq * hd * hd * nl
        bytes_dev = (16.0 * n_act / n_chips             # p+g+opt fp32 traffic
                     + 20.0 * tokens * d * L / n_chips)  # acts fwd+bwd+remat
        return flops / n_chips, bytes_dev
    if shape.kind == "prefill":
        tokens = B * S
        if cfg.encoder_decoder:
            n_enc, n_dec = _encdec_param_split(cfg)
            flops = 2.0 * (n_enc * B * cfg.n_encoder_tokens
                           + n_dec * tokens)
        else:
            flops = 2.0 * n_act * tokens
        for ctx, nl in _attn_context(cfg, S):
            flops += (2.0 * B * S * max(ctx, 1) / 2 * Hq * hd * nl
                      if ctx else 2.0 * B * S * Hq * hd * hd * nl)
        bytes_dev = (2.0 * n_act / n_chips
                     + 6.0 * tokens * d * L / n_chips)
        return flops / n_chips, bytes_dev
    # decode: one token per sequence; the cache read dominates memory
    flops = 2.0 * n_act * B
    for ctx, nl in _attn_context(cfg, S):
        flops += (4.0 * B * ctx * Hq * hd * nl if ctx
                  else 4.0 * B * Hq * hd * hd * nl)
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import tree_leaves
    caches = T.init_caches(cfg, B, S, device="meta")
    cache_bytes = sum(math.prod(l.shape) * l.element_size()
                      for l in tree_leaves(caches))
    bytes_dev = (2.0 * n_act + cache_bytes) / n_chips
    return flops / n_chips, bytes_dev


def _encdec_param_split(cfg):
    """(encoder_params, other_params) for enc-dec models — the encoder
    processes n_encoder_tokens frames, not the decoder sequence."""
    from repro_torch.models.transformer import init_params
    shapes = init_params(cfg, device="meta")
    n_enc = sum(_leaf_numels(shapes.get("enc_layers", {})))
    n_total = sum(_leaf_numels(shapes))
    return n_enc, n_total - n_enc


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (forward-only), N = active
    params for MoE.  Enc-dec models split: encoder params x encoder
    tokens + decoder params x decoder tokens."""
    from repro_torch.models.params import count_params_analytic
    B = shape.global_batch
    k = 6.0 if shape.kind == "train" else 2.0
    if cfg.encoder_decoder:
        n_enc, n_dec = _encdec_param_split(cfg)
        if shape.kind == "decode":
            return k * n_dec * B
        s_dec = min(shape.seq_len, cfg.max_seq_len)
        return k * (n_enc * B * cfg.n_encoder_tokens + n_dec * B * s_dec)
    n = count_params_analytic(cfg, active_only=True)
    if shape.kind == "decode":
        return k * n * B
    return k * n * B * shape.seq_len
