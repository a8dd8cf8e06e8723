"""Intra-function dataflow for the fslint rules.

Counterpart of ``repro/analysis/dataflow.py``.  The bucket flags and the
direction labels are the reference's; the device taint follows torch:
``torch.*`` calls (``torch.nn.functional`` included), methods of device
tensors and the port's kernel wrappers give device values.

Three small abstract interpreters over a linear (source-order) walk of
a function body.  Branches are walked in order and joined by union —
sound enough for a linter, and exactly the precision the repo's hot
path needs:

* **Bucket flags** (FS002): is an expression derived from a pow2
  bucketing helper (``bucketed``) or from a per-call varying size like
  ``len(...)`` without bucketing (``suspect``)?
* **Device taint** (FS003): does an expression hold a live device
  tensor (so ``np.asarray`` / ``int()`` / ``.item()`` / ``.cpu()`` on
  it forces a host sync)?  Class attributes assigned device values in any method
  are device-tainted in every method (the deferred-sync token ring
  buffer pattern in ``decode_runner.py``).
* **Direction labels** (FS004): which data-plane closures were created
  under a ``direction == "out"`` guard, so the swap-worker
  reachability check knows which closures a thread can actually run.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import (
    FunctionInfo,
    call_name,
    dotted_path,
    last_component,
)

# ---------------------------------------------------------------------------
# FS002: bucket flags
# ---------------------------------------------------------------------------

_ARRAY_CONSTRUCTORS = ("asarray", "array", "zeros", "ones", "full", "empty",
                       "arange", "tensor", "as_tensor", "from_numpy")
_SIZE_CALLS = ("len", "sum")
_HOST_ARRAY_ROOTS = ("np", "numpy")

# tensor methods whose result is on the device whatever the receiver
_TO_DEVICE_METHODS = ("to", "cuda")


@dataclass
class BucketFlags:
    bucketed: bool = False
    suspect: bool = False

    @staticmethod
    def join(flags: List["BucketFlags"]) -> "BucketFlags":
        bucketed = any(f.bucketed for f in flags)
        suspect = any(f.suspect for f in flags) and not bucketed
        return BucketFlags(bucketed, suspect)


class BucketEnv:
    """Source-order walk of one function computing bucket flags for
    every local name."""

    def __init__(self, fi: FunctionInfo, project) -> None:
        self.fi = fi
        self.project = project
        self.env: Dict[str, BucketFlags] = {}
        self._walk(fi.node.body)

    # -- expression evaluation --------------------------------------------

    def flags(self, expr: ast.expr) -> BucketFlags:
        if isinstance(expr, ast.Name):
            return self.env.get(expr.id, BucketFlags())
        if isinstance(expr, ast.Call):
            cn = call_name(expr)
            if cn is not None:
                bare = last_component(cn)
                if bare in self.project.bucketing_sources:
                    return BucketFlags(bucketed=True)
                if bare in _SIZE_CALLS and "." not in cn:
                    return BucketFlags(suspect=True)
                if bare in ("max", "min") and "." not in cn:
                    return BucketFlags.join([self.flags(a)
                                             for a in expr.args]) \
                        if expr.args else BucketFlags()
                if bare in _ARRAY_CONSTRUCTORS:
                    # flags of an array value follow its data/shape arg
                    if expr.args:
                        return self.flags(expr.args[0])
            return BucketFlags()
        if isinstance(expr, ast.BinOp):
            return BucketFlags.join([self.flags(expr.left),
                                     self.flags(expr.right)])
        if isinstance(expr, ast.UnaryOp):
            return self.flags(expr.operand)
        if isinstance(expr, (ast.Tuple, ast.List)):
            if not expr.elts:
                return BucketFlags()
            return BucketFlags.join([self.flags(e) for e in expr.elts])
        if isinstance(expr, ast.IfExp):
            return BucketFlags.join([self.flags(expr.body),
                                     self.flags(expr.orelse)])
        if isinstance(expr, ast.Subscript):
            return self.flags(expr.value)
        if isinstance(expr, ast.Starred):
            return self.flags(expr.value)
        return BucketFlags()

    # -- statement walk ----------------------------------------------------

    def _bind(self, target: ast.expr, flags: BucketFlags) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = flags
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, flags)

    def _walk(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, ast.Assign):
                value = stmt.value
                for target in stmt.targets:
                    if isinstance(target, (ast.Tuple, ast.List)) and \
                            isinstance(value, (ast.Tuple, ast.List)) and \
                            len(target.elts) == len(value.elts):
                        for t, v in zip(target.elts, value.elts):
                            self._bind(t, self.flags(v))
                    else:
                        self._bind(target, self.flags(value))
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                self._bind(stmt.target, self.flags(stmt.value))
            elif isinstance(stmt, ast.AugAssign):
                if isinstance(stmt.target, ast.Name):
                    cur = self.env.get(stmt.target.id, BucketFlags())
                    self.env[stmt.target.id] = BucketFlags.join(
                        [cur, self.flags(stmt.value)])
            elif isinstance(stmt, (ast.If,)):
                self._walk(stmt.body)
                self._walk(stmt.orelse)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._bind(stmt.target, self.flags(stmt.iter))
                self._walk(stmt.body)
                self._walk(stmt.orelse)
            elif isinstance(stmt, ast.While):
                self._walk(stmt.body)
                self._walk(stmt.orelse)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                self._walk(stmt.body)
            elif isinstance(stmt, ast.Try):
                self._walk(stmt.body)
                for h in stmt.handlers:
                    self._walk(h.body)
                self._walk(stmt.orelse)
                self._walk(stmt.finalbody)


# ---------------------------------------------------------------------------
# FS003: device taint
# ---------------------------------------------------------------------------

@dataclass
class SyncSite:
    node: ast.AST
    kind: str       # "np.asarray", "int()", ".item()", ".cpu()",
                    # "torch.cuda.synchronize", ".synchronize()",
                    # "implicit-bool"
    detail: str


class DeviceWalk:
    """Device-taint walk of one function.

    ``class_device_attrs`` maps a ``self``-relative attribute path
    (``"pools.gpu"``, ``"_pending"``) to its kind — ``"value"`` (the
    attribute IS a device array) or ``"container"`` (a host container
    holding device elements, like the deferred-token ring buffer;
    truthiness/len on it stay host, indexing/iteration yield device
    values).  ``device_returning`` is the set of project function
    qualnames whose return value is device-tainted.
    """

    def __init__(self, fi: FunctionInfo, project,
                 class_device_attrs: Dict[str, str],
                 device_returning: Set[str]) -> None:
        self.fi = fi
        self.project = project
        self.mod = fi.module
        self.class_attrs = class_device_attrs
        self.device_returning = device_returning
        self.env: Dict[str, bool] = {}
        self.syncs: List[SyncSite] = []
        self.attr_writes: Dict[str, str] = {}  # rel path -> kind
        self.returns_device = False
        self._walk(fi.node.body)

    @staticmethod
    def _self_rel(path: Optional[str]) -> Optional[str]:
        if path is not None and path.startswith("self."):
            return path[len("self."):]
        return None

    def _attr_kind(self, expr: ast.expr) -> Optional[str]:
        rel = self._self_rel(dotted_path(expr))
        if rel is None:
            return None
        return self.class_attrs.get(rel)

    # -- helpers -----------------------------------------------------------

    def _resolved_module_root(self, name: str) -> Optional[str]:
        root = name.split(".")[0]
        return self.mod.imports.get(root, root)

    def _full_path(self, name: str) -> str:
        head, _, rest = name.partition(".")
        full = self.mod.imports.get(head, head)
        return f"{full}.{rest}" if rest else full

    @staticmethod
    def _under(path: str, prefixes) -> bool:
        return any(path == p or path.startswith(p + ".") for p in prefixes)

    def _is_device_module_call(self, cn: str) -> bool:
        cfg = self.project.config
        full = self._full_path(cn)
        return (self._under(full, cfg.device_modules)
                and not self._under(full, cfg.host_calls)
                and not last_component(full).startswith(
                    cfg.host_call_prefix))

    def _is_numpy_call(self, cn: str) -> bool:
        full = self._resolved_module_root(cn)
        return full in ("numpy",) or cn.split(".")[0] in _HOST_ARRAY_ROOTS

    def device(self, expr: ast.expr) -> bool:
        cfg = self.project.config
        if isinstance(expr, ast.Name):
            return self.env.get(expr.id, False)
        if isinstance(expr, ast.Attribute):
            if expr.attr in cfg.host_meta_attrs:
                return False
            path = dotted_path(expr)
            if path is not None:
                if path in self.env:
                    return self.env[path]
                if self._attr_kind(expr) == "value":
                    return True
                if self._attr_kind(expr) is not None:
                    return False  # container itself is host
            return self.device(expr.value)
        if isinstance(expr, ast.Subscript):
            # indexing a device-element container yields a device value
            if self._attr_kind(expr.value) == "container":
                return True
            return self.device(expr.value)
        if isinstance(expr, ast.Call):
            return self._call_device(expr)
        if isinstance(expr, (ast.BinOp,)):
            return self.device(expr.left) or self.device(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self.device(expr.operand)
        if isinstance(expr, ast.Compare):
            ops_sync = [o for o in expr.ops
                        if not isinstance(o, (ast.Is, ast.IsNot,
                                              ast.In, ast.NotIn))]
            if not ops_sync:
                return False
            return self.device(expr.left) or \
                any(self.device(c) for c in expr.comparators)
        if isinstance(expr, ast.BoolOp):
            return any(self.device(v) for v in expr.values)
        if isinstance(expr, (ast.Tuple, ast.List)):
            return any(self.device(e) for e in expr.elts)
        if isinstance(expr, ast.IfExp):
            return self.device(expr.body) or self.device(expr.orelse)
        return False

    def _call_device(self, call: ast.Call) -> bool:
        cfg = self.project.config
        cn = call_name(call)
        method = (call.func.attr if isinstance(call.func, ast.Attribute)
                  else None)
        # tensor methods: host results, a copy to the device, or a new
        # device tensor from a device receiver
        if method is not None:
            if method in cfg.sync_methods or method in cfg.host_methods:
                return False
            if method in _TO_DEVICE_METHODS:
                return True
        if cn is None:
            return (method is not None
                    and self.device(call.func.value))  # f(x).m(...)
        bare = last_component(cn)
        # numpy conversions produce host values
        if self._is_numpy_call(cn) and "." in cn:
            return False
        if "." in cn and self._is_device_module_call(cn):
            return True
        if bare in cfg.device_functions:
            return True
        for target in self.project.resolve_call(call, self.mod, self.fi):
            if target.qualname in self.project.keyed_specs:
                return True
            if target.qualname in self.device_returning:
                return True
        if method is not None and self.device(call.func.value):
            return True
        return False

    # -- sync detection ----------------------------------------------------

    def _check_call(self, call: ast.Call) -> None:
        cfg = self.project.config
        cn = call_name(call)
        method = (call.func.attr if isinstance(call.func, ast.Attribute)
                  else None)
        if cn is not None and self._full_path(cn) in cfg.sync_calls:
            self.syncs.append(SyncSite(
                call, cn, f"{cn}() waits for the whole device"))
            return
        if method in cfg.stream_sync_methods and \
                self.project.is_torch_receiver_call(call, self.mod, self.fi):
            self.syncs.append(SyncSite(
                call, f".{method}()",
                f"an event or stream .{method}() blocks the host until "
                f"the device reaches it"))
            return
        if method in cfg.sync_methods and self.device(call.func.value):
            self.syncs.append(SyncSite(
                call, f".{method}()",
                f".{method}() on a device value forces a host sync"))
            return
        if cn is None:
            return
        bare = last_component(cn)
        if bare in ("asarray", "array") and self._is_numpy_call(cn) \
                and "." in cn and call.args and self.device(call.args[0]):
            self.syncs.append(SyncSite(
                call, "np.asarray",
                f"{cn}(...) on a device value blocks on the transfer"))
            return
        if bare in ("int", "float", "bool") and "." not in cn and \
                call.args and self.device(call.args[0]):
            self.syncs.append(SyncSite(
                call, f"{bare}()",
                f"{bare}() on a device value forces a host sync"))

    def _scan_expr(self, expr: Optional[ast.expr]) -> None:
        if expr is None:
            return
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._check_call(node)

    # -- statement walk ----------------------------------------------------

    def _bind(self, target: ast.expr, dev: bool) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = dev
        elif isinstance(target, ast.Attribute):
            path = dotted_path(target)
            if path is not None:
                self.env[path] = dev
                rel = self._self_rel(path)
                if dev and rel is not None:
                    self.attr_writes[rel] = "value"
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, dev)

    def _walk(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, ast.Assign):
                self._scan_expr(stmt.value)
                dev = self.device(stmt.value)
                for target in stmt.targets:
                    self._bind(target, dev)
            elif isinstance(stmt, ast.AnnAssign):
                self._scan_expr(stmt.value)
                if stmt.value is not None:
                    self._bind(stmt.target, self.device(stmt.value))
            elif isinstance(stmt, ast.AugAssign):
                self._scan_expr(stmt.value)
                if isinstance(stmt.target, ast.Name):
                    self.env[stmt.target.id] = (
                        self.env.get(stmt.target.id, False)
                        or self.device(stmt.value))
            elif isinstance(stmt, ast.Expr):
                self._scan_expr(stmt.value)
                # device values flowing into container attributes taint
                # the attribute for the whole class (ring buffers)
                if isinstance(stmt.value, ast.Call) and \
                        isinstance(stmt.value.func, ast.Attribute) and \
                        stmt.value.func.attr in ("append", "add", "extend"):
                    rel = self._self_rel(
                        dotted_path(stmt.value.func.value))
                    if rel is not None and \
                            any(self.device(a) for a in stmt.value.args):
                        self.attr_writes.setdefault(rel, "container")
            elif isinstance(stmt, ast.Return):
                self._scan_expr(stmt.value)
                if stmt.value is not None and self.device(stmt.value):
                    self.returns_device = True
            elif isinstance(stmt, ast.If):
                self._scan_expr(stmt.test)
                if self.device(stmt.test):
                    self.syncs.append(SyncSite(
                        stmt.test, "implicit-bool",
                        "branching on a device value forces a host sync"))
                self._walk(stmt.body)
                self._walk(stmt.orelse)
            elif isinstance(stmt, ast.While):
                self._scan_expr(stmt.test)
                if self.device(stmt.test):
                    self.syncs.append(SyncSite(
                        stmt.test, "implicit-bool",
                        "looping on a device value forces a host sync"))
                self._walk(stmt.body)
                self._walk(stmt.orelse)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan_expr(stmt.iter)
                elem_dev = (self.device(stmt.iter)
                            or self._attr_kind(stmt.iter) == "container")
                self._bind(stmt.target, elem_dev)
                self._walk(stmt.body)
                self._walk(stmt.orelse)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._scan_expr(item.context_expr)
                self._walk(stmt.body)
            elif isinstance(stmt, ast.Try):
                self._walk(stmt.body)
                for h in stmt.handlers:
                    self._walk(h.body)
                self._walk(stmt.orelse)
                self._walk(stmt.finalbody)
            elif isinstance(stmt, (ast.Assert, ast.Raise, ast.Delete)):
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Call):
                        self._check_call(node)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                pass   # nested defs are analysed as their own functions


def class_device_attrs(project, cls_module, class_name: str,
                       device_returning: Set[str]) -> Dict[str, str]:
    """Fixpoint of device-tainted attribute paths for one class
    (``"value"`` wins over ``"container"`` when both are observed)."""
    attrs: Dict[str, str] = {}
    methods = [fi for fi in cls_module.functions.values()
               if fi.class_name == class_name]
    changed = True
    while changed:
        changed = False
        for fi in methods:
            walk = DeviceWalk(fi, project, attrs, device_returning)
            for rel, kind in walk.attr_writes.items():
                if attrs.get(rel) not in ("value", kind):
                    attrs[rel] = ("value" if "value" in
                                  (attrs.get(rel), kind) else kind)
                    changed = True
    return attrs


def device_returning_functions(project) -> Set[str]:
    """Qualnames of project functions whose return value is
    device-tainted (fixpoint across modules)."""
    out: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for fi in project.functions.values():
            if fi.qualname in out:
                continue
            walk = DeviceWalk(fi, project, {}, out)
            if walk.returns_device:
                out.add(fi.qualname)
                changed = True
    return out


# ---------------------------------------------------------------------------
# FS004: direction-labelled closures
# ---------------------------------------------------------------------------

@dataclass
class ClosureRecord:
    label: Optional[str]            # "out", "in", or None (unknown)
    callees: Tuple[str, ...]        # resolved qualnames called by the body
    node: ast.AST                   # the lambda / def / name reference
    registered_at: Optional[ast.AST] = None


@dataclass
class DirectionFacts:
    """Per-project registry of data-plane closures and submit sites."""
    registered: List[ClosureRecord] = field(default_factory=list)
    # (module, call node, submit target quals, guard label)
    submit_sites: List[Tuple[object, ast.Call, Tuple[str, ...],
                             Optional[str]]] = field(default_factory=list)
    # functions that invoke a registered closure indirectly
    # (qual -> guard label at the `.copy_fn()` call, or None)
    indirect_callers: Dict[str, Optional[str]] = field(default_factory=dict)


def _direction_test_label(test: ast.expr, cfg) -> Optional[Tuple[str, bool]]:
    """If ``test`` (possibly inside an ``and``) compares the direction
    variable against a constant, return (label, exact) where ``exact``
    is True for a bare comparison (so the else-branch gets the
    complementary label) and False when the comparison is one conjunct
    of an ``and`` (else-branch label unknown)."""
    def match(cmp: ast.expr) -> Optional[str]:
        if not isinstance(cmp, ast.Compare) or len(cmp.ops) != 1:
            return None
        if not isinstance(cmp.ops[0], ast.Eq):
            return None
        left, right = cmp.left, cmp.comparators[0]
        for a, b in ((left, right), (right, left)):
            pa = dotted_path(a)
            if pa is not None and last_component(pa) == cfg.direction_var \
                    and isinstance(b, ast.Constant) \
                    and isinstance(b.value, str):
                return b.value
        return None

    direct = match(test)
    if direct is not None:
        return direct, True
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        for v in test.values:
            m = match(v)
            if m is not None:
                return m, False
    return None


class DirectionWalk:
    """Collect closure records and submit sites for one function."""

    def __init__(self, fi: FunctionInfo, project,
                 facts: DirectionFacts) -> None:
        self.fi = fi
        self.project = project
        self.cfg = project.config
        self.facts = facts
        self.env: Dict[str, List[ClosureRecord]] = {}
        self._walk(fi.node.body, label=None)

    def _lambda_record(self, node: ast.expr,
                       label: Optional[str]) -> Optional[ClosureRecord]:
        if isinstance(node, ast.Lambda):
            callees: List[str] = []
            for sub in ast.walk(node.body):
                if isinstance(sub, ast.Call):
                    for t in self.project.resolve_call(
                            sub, self.fi.module, self.fi):
                        callees.append(t.qualname)
            return ClosureRecord(label, tuple(callees), node)
        path = dotted_path(node)
        if path is not None:
            # a reference to a named function
            targets = self.project.resolve_name(path, self.fi.module, self.fi)
            if targets:
                return ClosureRecord(
                    label, tuple(t.qualname for t in targets), node)
        return None

    def _closures_of(self, expr: ast.expr,
                     label: Optional[str]) -> List[ClosureRecord]:
        if isinstance(expr, ast.Name) and expr.id in self.env:
            return list(self.env[expr.id])
        if isinstance(expr, ast.IfExp):
            return (self._closures_of(expr.body, label)
                    + self._closures_of(expr.orelse, label))
        if isinstance(expr, ast.Call):
            cn = call_name(expr)
            if cn is not None and last_component(cn) in \
                    self.cfg.passthrough_wrappers:
                out: List[ClosureRecord] = []
                for a in list(expr.args) + [k.value for k in expr.keywords]:
                    out.extend(self._closures_of(a, label))
                return out
            return []
        rec = self._lambda_record(expr, label)
        return [rec] if rec is not None else []

    def _register(self, expr: ast.expr, label: Optional[str],
                  site: ast.AST) -> None:
        for rec in self._closures_of(expr, label):
            rec.registered_at = site
            self.facts.registered.append(rec)

    def _scan_calls(self, expr: Optional[ast.expr],
                    label: Optional[str]) -> None:
        if expr is None:
            return
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            # executor.submit(f, ...) —— a thread dispatch site
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "submit" and node.args:
                targets: List[str] = []
                for t in self._closures_of(node.args[0], label):
                    targets.extend(t.callees)
                fpath = dotted_path(node.args[0])
                if fpath is not None:
                    for t in self.project.resolve_name(
                            fpath, self.fi.module, self.fi):
                        targets.append(t.qualname)
                self.facts.submit_sites.append(
                    (self.fi, node, tuple(targets), label))
            # keyword registration: f(..., copy_fn=<closure>)
            for kw in node.keywords:
                if kw.arg in self.cfg.copy_fn_names:
                    self._register(kw.value, label, node)
            # indirect invocation: task.copy_fn()
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in self.cfg.copy_fn_names:
                cur = self.facts.indirect_callers.get(self.fi.qualname)
                # keep the least restrictive guard seen (None < label)
                if self.fi.qualname not in self.facts.indirect_callers or \
                        cur is not None and label is None:
                    self.facts.indirect_callers[self.fi.qualname] = label

    def _walk(self, body: List[ast.stmt], label: Optional[str]) -> None:
        for stmt in body:
            if isinstance(stmt, ast.Assign):
                self._scan_calls(stmt.value, label)
                closures = self._closures_of(stmt.value, label)
                for target in stmt.targets:
                    if isinstance(target, ast.Name):
                        self.env[target.id] = closures
                    elif isinstance(target, ast.Attribute) and \
                            target.attr in self.cfg.copy_fn_names:
                        self._register(stmt.value, label, stmt)
            elif isinstance(stmt, ast.If):
                self._scan_calls(stmt.test, label)
                guard = _direction_test_label(stmt.test, self.cfg)
                if guard is not None:
                    body_label, exact = guard
                    other = None
                    if exact:
                        other = (self.cfg.out_label
                                 if body_label != self.cfg.out_label
                                 else "in")
                    self._walk(stmt.body, body_label)
                    self._walk(stmt.orelse, other if exact else label)
                else:
                    self._walk(stmt.body, label)
                    self._walk(stmt.orelse, label)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan_calls(stmt.iter, label)
                self._walk(stmt.body, label)
                self._walk(stmt.orelse, label)
            elif isinstance(stmt, ast.While):
                self._scan_calls(stmt.test, label)
                self._walk(stmt.body, label)
                self._walk(stmt.orelse, label)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._scan_calls(item.context_expr, label)
                self._walk(stmt.body, label)
            elif isinstance(stmt, ast.Try):
                self._walk(stmt.body, label)
                for h in stmt.handlers:
                    self._walk(h.body, label)
                self._walk(stmt.orelse, label)
                self._walk(stmt.finalbody, label)
            elif isinstance(stmt, (ast.Expr, ast.Return, ast.AugAssign,
                                   ast.AnnAssign, ast.Assert, ast.Raise)):
                for node in ast.iter_child_nodes(stmt):
                    if isinstance(node, ast.expr):
                        self._scan_calls(node, label)


def collect_direction_facts(project) -> DirectionFacts:
    facts = DirectionFacts()
    for fi in project.functions.values():
        DirectionWalk(fi, project, facts)
    return facts
