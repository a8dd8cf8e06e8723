"""Project index: call graph, keyed-function registry, receiver typing,
graph captures and identity returns.

Counterpart of ``repro/analysis/callgraph.py``.  Resolution is the
reference's, deliberately conservative for a linter:

* ``Name`` callees resolve through module-level defs and import maps.
* ``self.m(...)`` resolves to the enclosing class's method.
* ``obj.m(...)`` falls back to *every* project method named ``m`` —
  an over-approximation that keeps reachability sound (FS003/FS004
  would rather scan one extra function than miss the hot path behind
  ``runner.decode`` / ``pools.copy_in_staged``).

One exception, the port's receiver typing: ``x.synchronize()``,
``x.wait_event()``, ``x.record()``, ``x.query()`` (``Config.
torch_receiver_methods``) resolve to nothing when ``x`` is bound from a
``torch.cuda`` expression — an event or a stream, whose wait is a device
sync (FS003), not a project method that may await a future (FS005).

Where the reference indexes ``jax.jit`` defs and propagates donation,
the port indexes the capture-keyed and shape-keyed functions the
``Config`` lists (FS002), the tensors each CUDA graph capture is made
over (FS001), and, closed under wrappers, the parameters a function
returns as the same object (FS001: ``pools.gpu = runner.decode(views,
pools.gpu)`` rebinds the pool to itself).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import (
    FunctionInfo,
    ModuleInfo,
    call_name,
    dotted_path,
    iter_source_files,
    last_component,
    load_module,
    source_roots,
)
from repro_torch.analysis.core import Config


@dataclass
class KeyedSpec:
    """A capture-keyed or shape-keyed function, the parameters that key
    its variants (the reference's ``JitSpec.static_argnames``) and the
    value parameters that key none."""
    qualname: str
    shape_args: Tuple[str, ...] = ()
    value_args: Tuple[str, ...] = ()


def _unwrap_alias_target(node: ast.expr,
                         wrappers: Tuple[str, ...]) -> Optional[str]:
    """Dotted name of the function an alias call-form ultimately wraps,
    seen through the signature-preserving ``wrappers``; None when the
    target is dynamic."""
    if isinstance(node, (ast.Name, ast.Attribute)):
        return dotted_path(node)
    if isinstance(node, ast.Call) and node.args:
        if call_name(node) in wrappers:
            return _unwrap_alias_target(node.args[0], wrappers)
    return None


def _annotation_paths(node: Optional[ast.expr]) -> List[str]:
    """Every dotted path inside a type annotation (``Optional[torch.cuda.
    Event]`` gives ``Optional`` and ``torch.cuda.Event``; a string
    annotation is parsed)."""
    if node is None:
        return []
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return []
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Name, ast.Attribute)):
            p = dotted_path(sub)
            if p is not None:
                out.append(p)
    return out


class Project:
    """Cross-module index over a set of scanned source files."""

    def __init__(self, paths: List[Path], repo_root: Path, config: Config):
        self.config = config
        self.repo_root = repo_root
        self._walked: Dict[int, List[ast.AST]] = {}
        self.modules: Dict[str, ModuleInfo] = {}
        roots = source_roots(paths)
        for f in iter_source_files(paths):
            mod = load_module(f, roots, repo_root)
            if mod is not None:
                self.modules[mod.modname] = mod

        # qualname -> FunctionInfo, plus a bare-name index for the
        # conservative attribute-call fallback.
        self.functions: Dict[str, FunctionInfo] = {}
        self.by_bare_name: Dict[str, List[FunctionInfo]] = {}
        for mod in self.modules.values():
            for qual, fi in mod.functions.items():
                self.functions[qual] = fi
                self.by_bare_name.setdefault(fi.name, []).append(fi)

        # assignment-style alias qual -> the def it wraps; _build_edges
        # links the two so reachability covers the wrapped body.
        self._alias_of: Dict[str, str] = {}
        self._index_aliases()

        self.keyed_specs: Dict[str, KeyedSpec] = {}
        self._index_keyed()

        self._torch_attrs: Dict[Tuple[str, str], Set[str]] = {}
        self._torch_fields: Set[str] = set()
        self._torch_returning: Set[str] = set()
        self._torch_locals: Dict[str, Set[str]] = {}
        self._index_torch_types()

        self._edges: Dict[str, Set[str]] = {}
        self._build_edges()

        # qualname -> params returned as the same object (closed under
        # wrappers that return a callee's identity return)
        self.returned_params: Dict[str, Set[str]] = {}
        self._binding_cache: Dict[str, Dict[str, list]] = {}
        self._propagate_identity()

        # (module, class) -> self attributes a graph capture is made over,
        # and -> the methods allowed to rebind them (they recapture)
        self.captured_attrs: Dict[Tuple[str, str], Set[str]] = {}
        self.recapturing: Set[str] = set()
        self._capture_holders: Dict[Tuple[str, str], Set[str]] = {}
        self._index_captures()

        self.bucketing_sources: Set[str] = set(config.bucketing_helpers)
        self._derive_bucketing_sources()

        self.hot: Set[str] = set()
        self._compute_hot_set()

    def _nodes(self, fi: FunctionInfo) -> List[ast.AST]:
        """``ast.walk(fi.node)``, walked once per def."""
        key = id(fi.node)
        if key not in self._walked:
            self._walked[key] = list(ast.walk(fi.node))
        return self._walked[key]

    # -- alias and keyed-function registries ------------------------------

    def _index_aliases(self) -> None:
        """``g = wrapper(f, ...)`` (a ``Config.alias_wrappers`` call at
        module level): ``g`` stands for ``f``'s def."""
        cfg = self.config
        for mod in self.modules.values():
            for node in ast.walk(mod.tree):
                if not (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)
                        and call_name(node.value) in cfg.alias_wrappers
                        and node.value.args):
                    continue
                wrapped = _unwrap_alias_target(node.value.args[0],
                                               cfg.signature_wrappers)
                if not wrapped:
                    continue
                src = mod.functions.get(f"{mod.modname}.{wrapped}")
                if src is None:
                    continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        qual = f"{mod.modname}.{tgt.id}"
                        self.functions.setdefault(qual, src)
                        self._alias_of[qual] = src.qualname

    def _index_keyed(self) -> None:
        for suffix, shape_args, value_args in self.config.keyed_functions:
            for qual in self.functions:
                if qual == suffix or qual.endswith("." + suffix):
                    target = self.functions[qual].qualname
                    self.keyed_specs[target] = KeyedSpec(
                        target, tuple(shape_args), tuple(value_args))

    def keyed_spec_for(self, fi: FunctionInfo) -> Optional[KeyedSpec]:
        return self.keyed_specs.get(fi.qualname)

    # -- receiver typing ---------------------------------------------------

    def _full_path(self, path: Optional[str], mod: ModuleInfo
                   ) -> Optional[str]:
        """``path`` with its first component resolved through the
        module's imports (``cuda.Event`` after ``from torch import cuda``
        gives ``torch.cuda.Event``)."""
        if path is None:
            return None
        head, _, rest = path.partition(".")
        full = mod.imports.get(head, head)
        return f"{full}.{rest}" if rest else full

    def _under_torch_root(self, path: Optional[str], mod: ModuleInfo
                          ) -> bool:
        full = self._full_path(path, mod)
        return full is not None and any(
            full == r or full.startswith(r + ".")
            for r in self.config.torch_receiver_roots)

    def _annotated_torch(self, ann: Optional[ast.expr],
                         mod: ModuleInfo) -> bool:
        return any(self._under_torch_root(p, mod)
                   for p in _annotation_paths(ann))

    def torch_typed(self, expr: Optional[ast.expr], mod: ModuleInfo,
                    caller: Optional[FunctionInfo],
                    local: Optional[Set[str]] = None) -> bool:
        """Does ``expr`` hold a ``torch.cuda`` object (an event, a stream,
        or a container of them)?"""
        if expr is None:
            return False
        if local is None:
            local = (self._torch_locals.get(caller.qualname, set())
                     if caller is not None else set())
        if isinstance(expr, ast.Name):
            return expr.id in local
        if isinstance(expr, ast.Attribute):
            if self._under_torch_root(dotted_path(expr), mod):
                return True
            if isinstance(expr.value, ast.Name) and \
                    expr.value.id in ("self", "cls") and caller is not None \
                    and caller.class_name is not None:
                return expr.attr in self._torch_attrs.get(
                    (mod.modname, caller.class_name), set())
            return expr.attr in self._torch_fields
        if isinstance(expr, ast.Call):
            path = call_name(expr)
            if self._under_torch_root(path, mod):
                return True
            if isinstance(expr.func, ast.Attribute) and \
                    expr.func.attr in ("values", "get", "pop", "copy"):
                return self.torch_typed(expr.func.value, mod, caller, local)
            if path is not None:
                parts = path.split(".")
                if parts[0] in ("self", "cls") and len(parts) == 2 and \
                        caller is not None and caller.class_name:
                    q = f"{mod.modname}.{caller.class_name}.{parts[1]}"
                    return q in self._torch_returning
                q = self._full_path(path, mod)
                return (q in self._torch_returning
                        or f"{mod.modname}.{path}" in self._torch_returning)
            return False
        if isinstance(expr, ast.IfExp):
            return (self.torch_typed(expr.body, mod, caller, local)
                    or self.torch_typed(expr.orelse, mod, caller, local))
        if isinstance(expr, ast.BoolOp):
            return any(self.torch_typed(v, mod, caller, local)
                       for v in expr.values)
        if isinstance(expr, ast.Subscript):
            return self.torch_typed(expr.value, mod, caller, local)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return any(self.torch_typed(e, mod, caller, local)
                       for e in expr.elts)
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self.torch_typed(expr.elt, mod, caller, local)
        if isinstance(expr, ast.DictComp):
            return self.torch_typed(expr.value, mod, caller, local)
        return False

    def _bind_names(self, target: ast.expr, out: Set[str]) -> None:
        if isinstance(target, ast.Name):
            out.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind_names(e, out)

    def _function_torch_locals(self, fi: FunctionInfo) -> Set[str]:
        """Local names bound from ``torch.cuda`` objects in ``fi``
        (parameters annotated so included), to a fixpoint."""
        mod = fi.module
        a = fi.node.args
        local: Set[str] = set()
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if self._annotated_torch(p.annotation, mod):
                local.add(p.arg)
        changed = True
        while changed:
            changed = False
            for node in self._nodes(fi):
                value = None
                targets: List[ast.expr] = []
                if isinstance(node, ast.Assign):
                    value, targets = node.value, list(node.targets)
                elif isinstance(node, ast.AnnAssign):
                    value, targets = node.value, [node.target]
                    if self._annotated_torch(node.annotation, mod):
                        value = None
                        before = len(local)
                        self._bind_names(node.target, local)
                        changed |= len(local) != before
                elif isinstance(node, (ast.For, ast.AsyncFor,
                                       ast.comprehension)):
                    value, targets = node.iter, [node.target]
                elif isinstance(node, ast.withitem) and \
                        node.optional_vars is not None:
                    value, targets = node.context_expr, [node.optional_vars]
                if value is None or not targets:
                    continue
                if self.torch_typed(value, mod, fi, local):
                    before = len(local)
                    for t in targets:
                        self._bind_names(t, local)
                    changed |= len(local) != before
        return local

    def _index_torch_types(self) -> None:
        """Class attributes and dataclass fields holding ``torch.cuda``
        objects, functions annotated to return them, and each function's
        typed locals."""
        for fi in self.functions.values():
            if self._annotated_torch(fi.node.returns, fi.module):
                self._torch_returning.add(fi.qualname)
        for mod in self.modules.values():
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) and \
                            isinstance(stmt.target, ast.Name) and (
                                self._annotated_torch(stmt.annotation, mod)
                                or self.torch_typed(stmt.value, mod, None,
                                                    set())):
                        self._torch_fields.add(stmt.target.id)
                        self._torch_attrs.setdefault(
                            (mod.modname, node.name), set()).add(
                                stmt.target.id)
        for _ in range(3):   # attrs, locals and returns feed each other
            for fi in self.functions.values():
                self._torch_locals[fi.qualname] = \
                    self._function_torch_locals(fi)
            for fi in self.functions.values():
                if fi.class_name is None:
                    continue
                key = (fi.module.modname, fi.class_name)
                for node in self._nodes(fi):
                    if isinstance(node, (ast.Assign, ast.AnnAssign)):
                        targets = (node.targets if isinstance(node, ast.Assign)
                                   else [node.target])
                        typed = self.torch_typed(node.value, fi.module, fi)
                        if isinstance(node, ast.AnnAssign):
                            typed |= self._annotated_torch(node.annotation,
                                                           fi.module)
                        if not typed:
                            continue
                        for t in targets:
                            if isinstance(t, ast.Attribute) and \
                                    isinstance(t.value, ast.Name) and \
                                    t.value.id == "self":
                                self._torch_attrs.setdefault(
                                    key, set()).add(t.attr)
                    elif isinstance(node, ast.Return) and \
                            self.torch_typed(node.value, fi.module, fi):
                        self._torch_returning.add(fi.qualname)

    def is_torch_receiver_call(self, call: ast.Call, mod: ModuleInfo,
                               caller: Optional[FunctionInfo]) -> bool:
        """``x.m(...)`` with ``m`` a ``torch_receiver_methods`` name and
        ``x`` a ``torch.cuda`` object."""
        return (isinstance(call.func, ast.Attribute)
                and call.func.attr in self.config.torch_receiver_methods
                and self.torch_typed(call.func.value, mod, caller))

    # -- call resolution ------------------------------------------------

    def resolve_call(self, call: ast.Call, mod: ModuleInfo,
                     caller: Optional[FunctionInfo]) -> List[FunctionInfo]:
        name = call_name(call)
        if name is None:
            return []
        if self.is_torch_receiver_call(call, mod, caller):
            return []
        return self.resolve_name(name, mod, caller)

    def resolve_name(self, name: str, mod: ModuleInfo,
                     caller: Optional[FunctionInfo]) -> List[FunctionInfo]:
        parts = name.split(".")
        # plain name: module-level def, then imported symbol
        if len(parts) == 1:
            fi = self.functions.get(f"{mod.modname}.{name}")
            if fi is not None:
                return [fi]
            full = mod.imports.get(name)
            if full is not None and full in self.functions:
                return [self.functions[full]]
            return []
        # self.m / cls.m -> method on the enclosing class
        if parts[0] in ("self", "cls") and caller is not None \
                and caller.class_name is not None and len(parts) == 2:
            fi = self.functions.get(
                f"{mod.modname}.{caller.class_name}.{parts[1]}")
            return [fi] if fi is not None else []
        # import-alias rooted: ops.insert_prefill, repro_torch.kernels.ops.f
        root = mod.imports.get(parts[0])
        if root is not None:
            full = ".".join([root] + parts[1:])
            if full in self.functions:
                return [self.functions[full]]
        if name in self.functions:
            return [self.functions[name]]
        # Class.method in same module (e.g. FaultInjector.wrap_copy)
        if len(parts) == 2:
            fi = self.functions.get(f"{mod.modname}.{parts[0]}.{parts[1]}")
            if fi is not None:
                return [fi]
        # conservative fallback: any method with the same bare name
        bare = parts[-1]
        return [fi for fi in self.by_bare_name.get(bare, ())
                if fi.is_method]

    # -- call edges / reachability ---------------------------------------

    def _build_edges(self) -> None:
        for qual, fi in self.functions.items():
            callees: Set[str] = set()
            for node in self._nodes(fi):
                if not isinstance(node, ast.Call):
                    continue
                # calls inside a nested named def belong to that def's
                # edge set (it is indexed separately); lambdas fold
                # into the enclosing def.
                owner = fi.module.function_for(node)
                if owner is not None and owner.node is not fi.node:
                    continue
                for target in self.resolve_call(node, fi.module, fi):
                    callees.add(target.qualname)
            # link container -> nested def so reachability descends
            # into closures that are only *referenced* (registered as
            # callbacks), not called.
            for sub_qual, sub_fi in fi.module.functions.items():
                if sub_fi.node is not fi.node and \
                        sub_qual.startswith(qual + "."):
                    callees.add(sub_qual)
            wrapped = self._alias_of.get(qual)
            if wrapped is not None:
                callees.add(wrapped)
            self._edges[qual] = callees

    def callees(self, qual: str) -> Set[str]:
        return self._edges.get(qual, set())

    def reachable_from(self, roots: Iterable[str]) -> Set[str]:
        seen: Set[str] = set()
        stack = [r for r in roots if r in self.functions]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(self._edges.get(cur, ()))
        return seen

    # -- hot set ---------------------------------------------------------

    def _compute_hot_set(self) -> None:
        cfg = self.config
        roots = []
        for qual, fi in self.functions.items():
            if fi.name in cfg.hot_root_names or \
                    any(fi.name.startswith(p) for p in cfg.hot_root_prefixes):
                roots.append(qual)
        self.hot = self.reachable_from(roots)

    # -- identity returns (FS001) -----------------------------------------

    def _aliases_of_params(self, fi: FunctionInfo) -> Dict[str, str]:
        """Local name -> the parameter it is the same object as, where
        every binding of the name is that parameter or a call returning
        it (``pool = self.prefill_chunk_insert(rid, pool, staged)``)."""
        params = set(fi.params)
        bindings = self._bindings(fi)
        # optimistic: a parameter rebound only to itself stays itself
        alias: Dict[str, str] = {p: p for p in params}
        for _ in range(len(bindings) + 1):
            new = {p: p for p in params}
            for name, values in bindings.items():
                srcs = {self._identity_source(v, fi, alias) for v in values}
                if name in params:
                    srcs.add(name)
                if len(srcs) == 1 and None not in srcs:
                    new[name] = srcs.pop()
                else:
                    new.pop(name, None)
            if new == alias:
                break
            alias = new
        return alias

    def _bindings(self, fi: FunctionInfo
                  ) -> Dict[str, List[Optional[ast.expr]]]:
        """Local name -> the values bound to it in ``fi`` itself (None
        for a binding that is not a plain assignment)."""
        if fi.qualname in self._binding_cache:
            return self._binding_cache[fi.qualname]
        bindings: Dict[str, List[Optional[ast.expr]]] = {}
        for node in self._nodes(fi):
            if fi.module.function_for(node) is not fi:
                continue
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                                 ast.For, ast.AsyncFor)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Name):
                        ok = isinstance(node, (ast.Assign, ast.AnnAssign))
                        bindings.setdefault(t.id, []).append(
                            node.value if ok else None)
                    elif isinstance(t, (ast.Tuple, ast.List)):
                        names: Set[str] = set()
                        self._bind_names(t, names)
                        for n in names:
                            bindings.setdefault(n, []).append(None)
        self._binding_cache[fi.qualname] = bindings
        return bindings

    def _identity_source(self, expr: Optional[ast.expr], fi: FunctionInfo,
                         alias: Dict[str, str]) -> Optional[str]:
        """The parameter ``expr`` is the same object as, or None."""
        if isinstance(expr, ast.Name):
            return alias.get(expr.id)
        if isinstance(expr, ast.Call):
            for callee in self.resolve_call(expr, fi.module, fi):
                returned = self.returned_params.get(callee.qualname)
                if not returned:
                    continue
                for pname, arg in self.map_call_args(expr, callee):
                    if pname in returned and isinstance(arg, ast.Name) \
                            and arg.id in alias:
                        return alias[arg.id]
        return None

    def _propagate_identity(self) -> None:
        # only a function that returns a name or a call can return a
        # parameter as itself
        returns = {}
        for qual, fi in self.functions.items():
            rets = [node.value for node in self._nodes(fi)
                    if isinstance(node, ast.Return)
                    and fi.module.function_for(node) is fi]
            if rets and fi.params and all(
                    isinstance(v, (ast.Name, ast.Call)) for v in rets):
                returns[qual] = rets
        changed = True
        while changed:
            changed = False
            for qual, rets in returns.items():
                fi = self.functions[qual]
                alias = self._aliases_of_params(fi)
                srcs: Set[Optional[str]] = {
                    self._identity_source(v, fi, alias) for v in rets}
                if len(srcs) == 1 and None not in srcs:
                    got = {srcs.pop()}
                    if self.returned_params.get(qual) != got:
                        self.returned_params[qual] = got
                        changed = True

    def returns_same_object(self, expr: ast.expr, target: str,
                            fi: FunctionInfo) -> bool:
        """Is ``expr`` a call that returns the argument whose dotted path
        is ``target`` (``runner.decode(views, pools.gpu)`` for target
        ``pools.gpu``)?"""
        if not isinstance(expr, ast.Call):
            return False
        for callee in self.resolve_call(expr, fi.module, fi):
            returned = self.returned_params.get(callee.qualname)
            if not returned:
                continue
            for pname, arg in self.map_call_args(expr, callee):
                if pname in returned and dotted_path(arg) == target:
                    return True
        return False

    def map_call_args(self, call: ast.Call,
                      callee: FunctionInfo) -> List[Tuple[str, ast.expr]]:
        """(param_name, arg_expr) pairs for a call site.  For methods
        called attribute-style the implicit self consumes the first
        positional parameter."""
        params = callee.positional_params
        offset = 0
        if callee.is_method and isinstance(call.func, ast.Attribute):
            root = dotted_path(call.func)
            # ClassName.method(obj, ...) passes self explicitly
            if not (root and root.split(".")[0] == callee.class_name):
                offset = 1
        pairs: List[Tuple[str, ast.expr]] = []
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break
            idx = i + offset
            if idx < len(params):
                pairs.append((params[idx], arg))
        for kw in call.keywords:
            if kw.arg is not None:
                pairs.append((kw.arg, kw.value))
        return pairs

    # -- graph captures (FS001) --------------------------------------------

    def _self_attrs_of(self, expr: ast.expr, fi: FunctionInfo,
                       depth: int = 0) -> Set[str]:
        """``self`` attributes ``expr`` names: directly, in a tuple, or
        through a local bound to one, or a ``self.m(...)`` whose return
        names them."""
        out: Set[str] = set()
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self":
            out.add(expr.attr)
        elif isinstance(expr, (ast.Tuple, ast.List)):
            for e in expr.elts:
                out |= self._self_attrs_of(e, fi, depth)
        elif isinstance(expr, ast.Starred):
            out |= self._self_attrs_of(expr.value, fi, depth)
        elif isinstance(expr, ast.Name) and depth < 3:
            for node in self._nodes(fi):
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == expr.id
                        for t in node.targets):
                    out |= self._self_attrs_of(node.value, fi, depth + 1)
        elif isinstance(expr, ast.Call) and depth < 3:
            for callee in self.resolve_call(expr, fi.module, fi):
                if callee.class_name != fi.class_name:
                    continue
                for node in self._nodes(callee):
                    if isinstance(node, ast.Return) and node.value is not None:
                        out |= self._self_attrs_of(node.value, callee,
                                                   depth + 1)
        return out

    def _index_captures(self) -> None:
        cfg = self.config
        calls = dict(cfg.graph_capture_calls)
        for fi in self.functions.values():
            if fi.class_name is None:
                continue
            key = (fi.module.modname, fi.class_name)
            holders: Set[str] = set()
            captured: Set[str] = set()
            for node in self._nodes(fi):
                if isinstance(node, ast.Call):
                    cn = call_name(node)
                    idx = calls.get(last_component(cn)) if cn else None
                    if idx is not None and idx < len(node.args):
                        captured |= self._self_attrs_of(node.args[idx], fi)
                        # where the capture is kept: self.X or self.X[k]
                        stmt = fi.module.parents.get(node)
                        if isinstance(stmt, ast.Assign):
                            for t in stmt.targets:
                                base = t.value if isinstance(
                                    t, ast.Subscript) else t
                                if isinstance(base, ast.Attribute) and \
                                        isinstance(base.value, ast.Name) \
                                        and base.value.id == "self":
                                    holders.add(base.attr)
            if captured:
                self.captured_attrs.setdefault(key, set()).update(captured)
                self.recapturing.add(fi.qualname)
                self._capture_holders.setdefault(key, set()).update(holders)
        # a method that rebinds a capture holder drops every capture, so
        # it may rebind the captured tensors (the bucket rebuild)
        for fi in self.functions.values():
            if fi.class_name is None:
                continue
            held = self._capture_holders.get(
                (fi.module.modname, fi.class_name))
            if not held:
                continue
            for node in self._nodes(fi):
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self" and t.attr in held
                        for t in node.targets):
                    self.recapturing.add(fi.qualname)

    # -- bucketing sources (FS002) ----------------------------------------

    def _derive_bucketing_sources(self) -> None:
        """A function whose return expression calls an approved
        bucketing helper is itself a bucketing source (``_pad_runs``
        returns pow2-padded run tables)."""
        changed = True
        while changed:
            changed = False
            for qual, fi in self.functions.items():
                if last_component(qual) in self.bucketing_sources:
                    continue
                for node in self._nodes(fi):
                    if not isinstance(node, ast.Return) or node.value is None:
                        continue
                    for sub in ast.walk(node.value):
                        if isinstance(sub, ast.Call):
                            cn = call_name(sub)
                            if cn and last_component(cn) in \
                                    self.bucketing_sources:
                                self.bucketing_sources.add(
                                    last_component(qual))
                                changed = True
                                break

    def is_bucketing_call(self, call: ast.Call) -> bool:
        cn = call_name(call)
        return cn is not None and last_component(cn) in self.bucketing_sources
