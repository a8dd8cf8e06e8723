"""Core data model for fslint: findings, configuration, suppressions.

Counterpart of ``repro/analysis/core.py``: the data model, the
suppression syntax and the fingerprints are the reference's; the
``Config`` holds the port's torch conventions in place of the JAX ones.

A ``Finding`` is one rule violation at one source location.  Its
``fingerprint`` deliberately excludes the line number so a committed
baseline survives unrelated edits above the finding (see
``baseline.py``).

Suppressions are per-site trailing comments of the form
``fslint: disable=FS001(caller rebinds via return)`` (preceded by a
hash sign; spelled out here so this docstring does not register one).
A suppression applies to findings on its own line and on the line
directly below it (so it can sit on its own line above a long
statement).  The reason is mandatory — a bare ``disable=FS001`` is
itself reported as FS000 so undocumented waivers cannot accumulate.
"""
from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# FS000 is reserved for malformed suppression comments and cannot be
# disabled itself.
BAD_SUPPRESSION = "FS000"

_SUPPRESS_RE = re.compile(r"#\s*fslint:\s*disable=(.*)$")
_CLAUSE_RE = re.compile(r"\s*(FS\d{3})\s*\(([^()]*)\)\s*")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str        # repo-relative, forward slashes
    line: int        # 1-based
    col: int         # 0-based
    qualname: str    # enclosing function (module-qualified) or "<module>"
    message: str

    def fingerprint(self) -> str:
        """Stable, line-independent identity used by the baseline."""
        key = "|".join((self.rule, self.path, self.qualname, self.message))
        return hashlib.blake2b(key.encode("utf-8"), digest_size=10).hexdigest()

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.qualname}] {self.message}")

    def to_json(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "col": self.col, "qualname": self.qualname,
            "message": self.message, "fingerprint": self.fingerprint(),
        }


@dataclass
class Config:
    """Repo-tuned knobs; rules read conventions from here, never from
    hard-coded strings, so tests can retarget them at fixture trees."""

    # -- FS002: approved pow2 bucketing helpers (call by any alias path
    # whose final component matches).  Functions whose *return value*
    # contains a call to one of these become derived bucketing sources
    # (e.g. kernels/ops.py::_pad_runs).
    bucketing_helpers: Tuple[str, ...] = (
        "next_pow2", "_next_pow2", "slab_bucket_blocks", "page_tile",
        "_grow_to", "pow2_bucket",
    )
    # -- FS002: the capture-keyed and shape-keyed functions, the port's
    # counterparts of the reference's jitted variants: (qualname suffix,
    # the parameters that key a variant, the value parameters that key
    # none — host ints the reference passes as traced scalars).  The
    # decode step is captured as one CUDA graph per (batch, pages)
    # bucket; the staged swap copies, the prefill insert and the chunk
    # forward launch a kernel or allocate per padded shape.
    # ``launch/dryrun.py --audit-jit`` holds their live key counts to
    # the bound these rows give.
    keyed_functions: Tuple[Tuple[str, Tuple[str, ...], Tuple[str, ...]],
                           ...] = (
        ("models.paged.paged_decode_step_device", ("sampled",), ()),
        ("models.paged.prefill_kv_chunk", (), ("prefix_len", "chunk_len")),
        ("kernels.ops._gather_swap", ("n_slab", "run_blocks"), ()),
        ("kernels.ops._scatter_swap", ("run_blocks",), ()),
        ("kernels.ops._insert_prefill", ("block_size",), ()),
    )
    # Calls ``g = wrapper(f, ...)`` that make ``g`` stand for ``f``, and
    # the signature-preserving wrappers seen through inside them (the
    # reference's ``jax.jit`` / ``shard_map`` / ``partial`` aliases).
    alias_wrappers: Tuple[str, ...] = ("torch.compile",)
    signature_wrappers: Tuple[str, ...] = ("functools.partial", "partial")

    # -- FS003: modules whose calls produce device values (prefix match
    # on the import-resolved dotted path) and the calls among them that
    # do not (host tensors, predicates, stream and event objects); the
    # port's kernel wrappers and sampler, whose results are device
    # values (bare-name match: ``kernels/ops.py``, ``paged_attention``,
    # ``block_copy``, ``flash_attention``, ``gla_scan``,
    # ``models/paged.py::sample_tokens``); and the documented staged-copy
    # sync points that are allowed to block.
    device_modules: Tuple[str, ...] = ("torch",)
    # predicates (``torch.is_grad_enabled``) answer on the host
    host_call_prefix: str = "is_"
    host_calls: Tuple[str, ...] = (
        "torch.cuda", "torch.from_numpy", "torch.device",
        "torch.get_default_dtype", "torch.manual_seed", "torch.Generator",
        "torch.no_grad", "torch.inference_mode", "torch.autograd",
        "torch.distributed", "torch.utils", "torch.profiler",
    )
    device_functions: Tuple[str, ...] = (
        "sample_tokens", "paged_attention", "block_copy",
        "block_copy_grouped", "block_gather_runs", "block_scatter_runs",
        "flash_attention", "gla_scan_scalar", "copy_blocks",
        "copy_block_runs", "gather_swap_runs", "scatter_swap_runs",
        "insert_prefill", "prefill_chunk", "seed_prefill_carry", "to_device",
    )
    # tensor attributes and methods that live on the host
    host_meta_attrs: Tuple[str, ...] = (
        "shape", "dtype", "ndim", "device", "is_cuda", "layout",
        "requires_grad", "nbytes", "itemsize",
    )
    host_methods: Tuple[str, ...] = (
        "size", "numel", "dim", "data_ptr", "stride", "element_size",
        "is_contiguous", "get_device", "storage_offset", "is_pinned",
    )
    # tensor methods that copy to the host and so wait for the device
    sync_methods: Tuple[str, ...] = ("item", "tolist", "cpu", "numpy")
    # calls that wait for the whole device
    sync_calls: Tuple[str, ...] = ("torch.cuda.synchronize",)
    sync_allowlist: Tuple[str, ...] = (
        "PagedPools.copy_out_staged", "PagedPools.copy_in_staged",
    )

    # -- receiver typing: ``x.<method>()`` with one of these names does
    # not resolve to a project method when ``x`` is bound from an
    # expression under one of the roots (a CUDA event or stream); on
    # such a receiver ``synchronize`` is a host sync (FS003).
    torch_receiver_methods: Tuple[str, ...] = (
        "synchronize", "wait_event", "record", "query", "wait_stream",
    )
    torch_receiver_roots: Tuple[str, ...] = ("torch.cuda",)
    stream_sync_methods: Tuple[str, ...] = ("synchronize",)

    # -- hot-path roots: a function is "hot" when its bare name matches
    # one of these (or starts with a listed prefix) or it is reachable
    # from a hot function through the project call graph.
    hot_root_names: Tuple[str, ...] = ("step", "decode")
    hot_root_prefixes: Tuple[str, ...] = ("prefill",)

    # -- FS001/FS004/FS006: attribute paths whose final component names a
    # device pool.  Pool mutators (FS004) are the functions that assign a
    # pool attribute, write one in place, or are named here (qualname
    # suffix).
    pool_attr_names: Tuple[str, ...] = ("gpu", "pool")
    pool_writers: Tuple[str, ...] = (
        "ops.scatter_swap_runs", "PagedPools.copy_in",
        "PagedPools.copy_in_staged",
    )
    # -- FS001: what a CUDA graph is captured over.  A call to one of
    # ``graph_capture_calls`` (callee's final component, index of the
    # argument holding the captured tensors) captures the ``self``
    # attributes that argument names, directly or through a method that
    # returns them.  The pool attributes are captured by convention.
    graph_capture_calls: Tuple[Tuple[str, int], ...] = (("_StepGraph", 1),)
    # -- FS006: calls whose result is a new tensor (a copy of their
    # operands); a pool attribute bound to one over a pool is a
    # whole-pool copy.
    out_of_place_ops: Tuple[str, ...] = (
        "index_put", "index_copy", "index_add", "index_fill", "scatter",
        "scatter_add", "masked_fill", "masked_scatter", "where", "clone",
        "cat", "stack", "add", "sub", "mul", "contiguous",
    )
    # Wrappers that return their callable argument (possibly decorated):
    # closure direction labels flow through them unchanged.
    passthrough_wrappers: Tuple[str, ...] = ("wrap_copy",)
    # Attribute/keyword names under which data-plane closures are
    # registered for (possibly threaded) execution.
    copy_fn_names: Tuple[str, ...] = ("copy_fn",)
    # Name of the direction variable tested to segregate d2h from h2d.
    direction_var: str = "direction"
    out_label: str = "out"

    # -- FS005: lock attributes are recognised by suffix match on the
    # final component.
    lock_suffix: str = "lock"

    # -- FS007: calls that block the event loop inside ``async def``
    # bodies (the front-end's streaming server shares one loop across
    # every connection — one blocking call stalls them all).  Dotted
    # entries match the call path exactly or by suffix ("time.sleep"
    # also catches an aliased import); attr entries match any
    # ``obj.<attr>()`` call, the device ones with their own message.  A
    # call that is DIRECTLY awaited is exempt (``await ws.recv()``
    # yields to the loop).
    async_blocking_calls: Tuple[str, ...] = (
        "time.sleep", "torch.cuda.synchronize",
    )
    async_blocking_attrs: Tuple[str, ...] = (
        "result", "recv", "recv_into", "recvfrom", "sendall", "accept",
    )
    async_device_attrs: Tuple[str, ...] = (
        "item", "tolist", "cpu", "numpy", "synchronize",
    )

    # Rules to run (None = all registered).
    rules: Optional[Tuple[str, ...]] = None


@dataclass
class Suppressions:
    """Parsed per-site disable comments for one file."""

    # line -> {rule -> reason}
    by_line: Dict[int, Dict[str, str]] = field(default_factory=dict)
    malformed: List[Tuple[int, str]] = field(default_factory=list)

    def covers(self, line: int, rule: str) -> bool:
        for ln in (line, line - 1):
            clauses = self.by_line.get(ln)
            if clauses and rule in clauses:
                return True
        return False


def parse_suppressions(source: str) -> Suppressions:
    sup = Suppressions()
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m is None:
            continue
        body = m.group(1).strip()
        clauses: Dict[str, str] = {}
        pos, ok = 0, True
        while pos < len(body):
            cm = _CLAUSE_RE.match(body, pos)
            if cm is None:
                ok = False
                break
            rule, reason = cm.group(1), cm.group(2).strip()
            if not reason or rule == BAD_SUPPRESSION:
                ok = False
                break
            clauses[rule] = reason
            pos = cm.end()
            if pos < len(body):
                if body[pos] != ",":
                    ok = False
                    break
                pos += 1
        if ok and clauses:
            sup.by_line[lineno] = clauses
        else:
            sup.malformed.append((lineno, body))
    return sup
