"""AST plumbing shared by the fslint rules.

Counterpart of ``repro/analysis/astutil.py``, unchanged: the syntactic
layer knows no framework.

Everything here is syntactic: dotted-path flattening, parent links,
qualified names, and per-module import maps.  Semantic layers (call
graph, capture and identity registries, taint) live in ``callgraph.py`` /
``dataflow.py``.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Union

from repro_torch.analysis.core import Suppressions, parse_suppressions

FuncNode = Union[ast.FunctionDef, ast.AsyncFunctionDef]


def dotted_path(node: ast.AST) -> Optional[str]:
    """Flatten ``a.b.c`` (Name/Attribute chains) to ``"a.b.c"``.
    Returns None for anything else (subscripts, calls, literals)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_component(path: str) -> str:
    return path.rsplit(".", 1)[-1]


def call_name(call: ast.Call) -> Optional[str]:
    """Dotted path of a call's callee, or None (e.g. ``f()()``)."""
    return dotted_path(call.func)


def walk_with_parents(root: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(root):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def node_contains(outer: ast.AST, inner: ast.AST,
                  parents: Dict[ast.AST, ast.AST]) -> bool:
    cur: Optional[ast.AST] = inner
    while cur is not None:
        if cur is outer:
            return True
        cur = parents.get(cur)
    return False


def enclosing_statement(node: ast.AST,
                        parents: Dict[ast.AST, ast.AST]) -> Optional[ast.stmt]:
    cur: Optional[ast.AST] = node
    while cur is not None and not isinstance(cur, ast.stmt):
        cur = parents.get(cur)
    return cur if isinstance(cur, ast.stmt) else None


def enclosing_loop(node: ast.AST, stop: ast.AST,
                   parents: Dict[ast.AST, ast.AST]) -> Optional[ast.stmt]:
    """Innermost For/While between ``node`` and ``stop`` (exclusive)."""
    cur = parents.get(node)
    while cur is not None and cur is not stop:
        if isinstance(cur, (ast.For, ast.While)):
            return cur
        cur = parents.get(cur)
    return None


def assign_target_paths(stmt: ast.stmt) -> List[str]:
    """Dotted paths bound by an assignment statement (tuple targets
    flattened; subscript/starred targets are skipped)."""
    targets: List[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.For):
        targets = [stmt.target]
    paths: List[str] = []
    queue = list(targets)
    while queue:
        t = queue.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            queue.extend(t.elts)
        else:
            p = dotted_path(t)
            if p is not None:
                paths.append(p)
    return paths


@dataclass
class FunctionInfo:
    qualname: str            # module.Class.func or module.func
    node: FuncNode
    module: "ModuleInfo"
    class_name: Optional[str]

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def is_method(self) -> bool:
        return self.class_name is not None

    @property
    def params(self) -> List[str]:
        a = self.node.args
        return ([p.arg for p in a.posonlyargs] + [p.arg for p in a.args]
                + ([a.vararg.arg] if a.vararg else [])
                + [p.arg for p in a.kwonlyargs]
                + ([a.kwarg.arg] if a.kwarg else []))

    @property
    def positional_params(self) -> List[str]:
        a = self.node.args
        return [p.arg for p in a.posonlyargs] + [p.arg for p in a.args]


@dataclass
class ModuleInfo:
    modname: str             # dotted, e.g. "repro.kernels.ops"
    path: Path               # absolute
    rel_path: str            # repo-relative, forward slashes
    tree: ast.Module
    source: str
    suppressions: Suppressions
    parents: Dict[ast.AST, ast.AST] = field(default_factory=dict)
    imports: Dict[str, str] = field(default_factory=dict)  # alias -> full
    functions: Dict[str, FunctionInfo] = field(default_factory=dict)
    # id(def node) -> its FunctionInfo, rebuilt when ``functions`` grows
    _def_index: Dict[int, FunctionInfo] = field(default_factory=dict,
                                                repr=False)

    def function_for(self, node: ast.AST) -> Optional[FunctionInfo]:
        """Innermost enclosing def of a node (lambdas belong to their
        enclosing def)."""
        if len(self._def_index) != len(self.functions):
            self._def_index = {id(fi.node): fi
                               for fi in self.functions.values()}
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = self._def_index.get(id(cur))
                if fi is not None:
                    return fi
            cur = self.parents.get(cur)
        return None


def _collect_imports(tree: ast.Module) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out[alias.asname or alias.name.split(".")[0]] = (
                    alias.name if alias.asname else alias.name.split(".")[0])
                if alias.asname:
                    out[alias.asname] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for alias in node.names:
                out[alias.asname or alias.name] = f"{node.module}.{alias.name}"
    return out


def _collect_functions(mod: ModuleInfo) -> None:
    def visit(body: List[ast.stmt], prefix: str, cls: Optional[str]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{stmt.name}"
                mod.functions[qual] = FunctionInfo(qual, stmt, mod, cls)
                # nested defs: qualify but keep the nearest class tag
                visit(stmt.body, qual, cls)
            elif isinstance(stmt, ast.ClassDef):
                visit(stmt.body, f"{prefix}.{stmt.name}", stmt.name)
    visit(mod.tree.body, mod.modname, None)


def modname_for(path: Path, roots: List[Path]) -> str:
    """Dotted module name for a source file.

    A ``src`` directory anywhere on the path is treated as the import
    root (``src/repro/kernels/ops.py`` -> ``repro.kernels.ops``).
    Otherwise the file is named relative to the shallowest scanned
    root that contains it (fixture trees: ``tmp/mod.py`` -> ``mod``).
    """
    p = path.resolve()
    parts = p.with_suffix("").parts
    if "src" in parts:
        idx = len(parts) - 1 - parts[::-1].index("src")
        tail = list(parts[idx + 1:])
    else:
        tail = None
        for root in sorted(roots, key=lambda r: len(str(r))):
            try:
                rel = p.relative_to(root.resolve())
            except ValueError:
                continue
            tail = list(rel.with_suffix("").parts)
            break
        if tail is None:
            tail = [p.stem]
    if tail and tail[-1] == "__init__":
        tail = tail[:-1]
    return ".".join(tail) if tail else p.stem


def load_module(path: Path, roots: List[Path],
                repo_root: Path) -> Optional[ModuleInfo]:
    try:
        source = path.read_text(encoding="utf-8")
        tree = ast.parse(source, filename=str(path))
    except (OSError, SyntaxError):
        return None
    try:
        rel = str(path.resolve().relative_to(repo_root.resolve()))
    except ValueError:
        rel = str(path)
    mod = ModuleInfo(
        modname=modname_for(path, roots), path=path.resolve(),
        rel_path=rel.replace("\\", "/"), tree=tree, source=source,
        suppressions=parse_suppressions(source),
    )
    mod.parents = walk_with_parents(tree)
    mod.imports = _collect_imports(tree)
    _collect_functions(mod)
    return mod


def iter_source_files(paths: List[Path]) -> Iterator[Path]:
    seen = set()
    for p in paths:
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            r = f.resolve()
            if r not in seen and r.suffix == ".py":
                seen.add(r)
                yield r


def source_roots(paths: List[Path]) -> List[Path]:
    """Scanned base directories, used by ``modname_for`` for trees
    without a ``src`` layout (fixture directories in tests)."""
    return [(p if p.is_dir() else p.parent).resolve() for p in paths]
