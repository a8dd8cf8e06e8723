"""The fslint rule set for the port's torch hot path.

Counterpart of ``repro/analysis/rules.py``.  Each rule keeps its ID and
its discipline; the JAX rules take that discipline's torch meaning
(DESIGN.md §8 has the reference's catalog):

* FS001 rebind of a graph-captured tensor — a CUDA graph replays over
  the addresses it was captured at (the reference's use-after-donate:
  the owner-of-record protocol becomes "write in place").
* FS002 graph-and-bucket budget — every capture-keyed or shape-keyed
  call site buckets its shape-determining arguments to pow2.
* FS003 host sync in hot path — ``.item()`` / ``.tolist()`` /
  ``.cpu()`` / ``.numpy()``, ``int()`` or a branch on a device tensor,
  ``torch.cuda.synchronize()`` and event or stream ``.synchronize()``.
* FS004 swap-plane thread discipline — worker threads run read-only
  d2h gathers only (no pool writes).
* FS005 lock-order / await-outside-lock — swap_manager's "await copy
  deps *before* taking the pool lock" contract.
* FS006 whole-pool out-of-place write — a pool attribute rebound to a
  new tensor computed over the pool copies the entire pool.
* FS007 blocking call in async def — the front-end's single event loop
  must never run thread sleeps, synchronous future waits, raw socket I/O
  or device waits.

Rules report syntactic facts with dataflow just deep enough to avoid
noise; they are deliberately intra-module (plus a project call graph)
and never import torch.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import (
    FunctionInfo,
    call_name,
    dotted_path,
    last_component,
)
from repro_torch.analysis.callgraph import Project
from repro_torch.analysis.core import Finding
from repro_torch.analysis.dataflow import (
    BucketEnv,
    DeviceWalk,
    class_device_attrs,
    collect_direction_facts,
    device_returning_functions,
)


class Rule:
    id: str = "FS000"
    title: str = ""

    def run(self, project: Project) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError


def _finding(rule: str, fi: FunctionInfo, node: ast.AST,
             message: str) -> Finding:
    return Finding(
        rule=rule, path=fi.module.rel_path,
        line=getattr(node, "lineno", fi.node.lineno),
        col=getattr(node, "col_offset", 0),
        qualname=fi.qualname, message=message)


def _owned_calls(fi: FunctionInfo) -> List[ast.Call]:
    """Call nodes belonging to ``fi`` itself (lambdas included, nested
    named defs excluded — they are analysed separately)."""
    out = []
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Call):
            owner = fi.module.function_for(node)
            if owner is None or owner.node is fi.node:
                out.append(node)
    return out


# ---------------------------------------------------------------------------
# FS001 — rebind of a graph-captured tensor
# ---------------------------------------------------------------------------

class CapturedTensorRebind(Rule):
    """A CUDA graph replays over the addresses it was captured at.  A
    hot function that binds a captured tensor (the pool, or a ``self``
    attribute a capture was made over) to a new tensor leaves the graph
    reading and writing the old one: ``_StepGraph.check`` refuses such a
    replay at run time, this rule before it runs.  Writes in place
    (``copy_``, slice assignment) and rebinds to a call that returns the
    same object (``pools.gpu = runner.decode(views, pools.gpu)``) are
    fine; so is the method that recaptures (it drops the old graphs)."""
    id = "FS001"
    title = "captured-tensor-rebind"

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        pools = project.config.pool_attr_names
        for qual, fi in project.functions.items():
            if qual not in project.hot or fi.name == "__init__" or \
                    qual in project.recapturing:
                continue
            captured: Set[str] = set()
            if fi.class_name is not None:
                captured = project.captured_attrs.get(
                    (fi.module.modname, fi.class_name), set())
            for node in ast.walk(fi.node):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)) or \
                        node.value is None or \
                        fi.module.function_for(node) is not fi:
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if not isinstance(t, ast.Attribute):
                        continue
                    path = dotted_path(t)
                    own = (isinstance(t.value, ast.Name)
                           and t.value.id == "self" and t.attr in captured)
                    if path is None or not (own or t.attr in pools):
                        continue
                    if project.returns_same_object(node.value, path, fi):
                        continue
                    kind = ("the pool" if t.attr in pools else
                            "a tensor of a capture in this class")
                    findings.append(_finding(
                        self.id, fi, node,
                        f"'{path}' is bound to a new tensor, but a CUDA "
                        f"graph was captured over the old one ({kind}); "
                        f"write it in place (copy_, slice assignment) or "
                        f"rebind it to the same object"))
        return findings


# ---------------------------------------------------------------------------
# FS002 — graph-and-bucket budget
# ---------------------------------------------------------------------------

class GraphBucketBudget(Rule):
    id = "FS002"
    title = "graph-and-bucket-budget"

    def __init__(self) -> None:
        # qualname of a keyed function -> max bucketed shape-key degrees
        # observed at any hot call site; consumed by
        # `launch/dryrun.py --audit-jit`.
        self.degrees: Dict[str, int] = {}

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        self.degrees = {}
        for qual, fi in project.functions.items():
            if qual not in project.hot:
                continue
            benv = BucketEnv(fi, project)
            for call in _owned_calls(fi):
                for callee in project.resolve_call(call, fi.module, fi):
                    spec = project.keyed_specs.get(callee.qualname)
                    if spec is None:
                        continue
                    bucketed = 0
                    for pname, arg in project.map_call_args(call, callee):
                        flags = benv.flags(arg)
                        # one degree of freedom per bucketed shape key;
                        # tensor shapes are bucketed with these, so the
                        # audit bound stays tight
                        if flags.bucketed and pname in spec.shape_args:
                            bucketed += 1
                        if not flags.suspect or pname in spec.value_args:
                            continue
                        kind = ("shape-key arg"
                                if pname in spec.shape_args
                                else "tensor arg")
                        findings.append(_finding(
                            self.id, fi, arg,
                            f"{kind} '{pname}' of keyed "
                            f"{last_component(callee.qualname)} derives "
                            f"from a per-call size; route it through a "
                            f"pow2 bucketing helper or a graph or kernel "
                            f"variant is made per distinct value"))
                    cur = self.degrees.get(callee.qualname, 0)
                    self.degrees[callee.qualname] = max(cur, bucketed)
        return findings


# ---------------------------------------------------------------------------
# FS003 — host sync in hot path
# ---------------------------------------------------------------------------

class HostSyncInHotPath(Rule):
    id = "FS003"
    title = "host-sync-in-hot-path"

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        device_returning = device_returning_functions(project)
        attr_cache: Dict[Tuple[str, str], Dict[str, str]] = {}
        allow = project.config.sync_allowlist
        for qual, fi in project.functions.items():
            if qual not in project.hot:
                continue
            if any(qual.endswith(suffix) for suffix in allow):
                continue
            attrs: Dict[str, str] = {}
            if fi.class_name is not None:
                key = (fi.module.modname, fi.class_name)
                if key not in attr_cache:
                    attr_cache[key] = class_device_attrs(
                        project, fi.module, fi.class_name, device_returning)
                attrs = attr_cache[key]
            walk = DeviceWalk(fi, project, attrs, device_returning)
            for site in walk.syncs:
                findings.append(_finding(
                    self.id, fi, site.node,
                    f"{site.detail} inside the serving hot path; defer it "
                    f"or move it to a documented staged sync point"))
        return findings


# ---------------------------------------------------------------------------
# FS004 — swap-plane thread discipline
# ---------------------------------------------------------------------------

class SwapThreadDiscipline(Rule):
    id = "FS004"
    title = "swap-thread-discipline"

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        cfg = project.config
        facts = collect_direction_facts(project)
        mutators = self._pool_mutators(project)
        for submit_fi, call, targets, guard in facts.submit_sites:
            reachable = project.reachable_from(targets)
            # expand through indirect `task.copy_fn()` dispatch: which
            # registered closures can a worker thread actually run?
            for _ in range(4):  # closures may chain; small fixpoint
                extra: List[str] = []
                for qual in list(reachable):
                    if qual not in facts.indirect_callers:
                        continue
                    for rec in facts.registered:
                        if guard == cfg.out_label and \
                                rec.label == "in":
                            continue  # provably h2d-only: not submitted
                        extra.extend(rec.callees)
                new = project.reachable_from(extra) - reachable
                if not new:
                    break
                reachable |= new
            hit = sorted(reachable & mutators)
            if hit:
                findings.append(_finding(
                    self.id, submit_fi, call,
                    f"pool-mutating op(s) {', '.join(hit[:3])} reachable "
                    f"from a swap worker thread; workers may only run "
                    f"read-only d2h gathers (residency contract)"))
        return findings

    @staticmethod
    def _pool_mutators(project: Project) -> Set[str]:
        """Functions that assign a pool attribute, write a pool in place
        (slice assignment or an in-place ``m_`` method on a pool-named
        tensor), or are listed as pool writers."""
        cfg = project.config
        names = cfg.pool_attr_names

        def pool_named(node: ast.expr) -> bool:
            path = dotted_path(node)
            return path is not None and last_component(path) in names

        mutators: Set[str] = set()
        for qual, fi in project.functions.items():
            if any(qual == w or qual.endswith("." + w)
                   for w in cfg.pool_writers):
                mutators.add(qual)
                continue
            for node in ast.walk(fi.node):
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    for t in targets:
                        if isinstance(t, ast.Attribute) and t.attr in names:
                            mutators.add(qual)
                        elif isinstance(t, ast.Subscript) and \
                                pool_named(t.value):
                            mutators.add(qual)
                elif isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute):
                    m = node.func.attr
                    if m.endswith("_") and not m.startswith("_") and \
                            pool_named(node.func.value):
                        mutators.add(qual)
        return mutators


# ---------------------------------------------------------------------------
# FS005 — lock order / await under pool lock
# ---------------------------------------------------------------------------

class LockDiscipline(Rule):
    id = "FS005"
    title = "lock-discipline"

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        suffix = project.config.lock_suffix
        awaiting = self._direct_awaiters(project)
        acquires = self._direct_acquires(project, suffix)
        reach_cache: Dict[str, Set[str]] = {}

        def reach(qual: str) -> Set[str]:
            if qual not in reach_cache:
                reach_cache[qual] = project.reachable_from([qual])
            return reach_cache[qual]

        edges: Dict[str, Set[str]] = {}
        edge_sites: Dict[Tuple[str, str], Tuple[FunctionInfo, ast.AST]] = {}

        for qual, fi in project.functions.items():
            self._scan(project, fi, fi.node.body, [], suffix, awaiting,
                       acquires, reach, findings, edges, edge_sites)

        # lock-order cycles across the whole project
        for a, b in self._cycle_edges(edges):
            fi, site = edge_sites[(a, b)]
            findings.append(_finding(
                self.id, fi, site,
                f"lock-order cycle: '{a}' is held while acquiring '{b}' "
                f"and elsewhere the reverse; pick one global order"))
        return findings

    # -- project scans ----------------------------------------------------

    @staticmethod
    def _direct_awaiters(project: Project) -> Set[str]:
        out: Set[str] = set()
        for qual, fi in project.functions.items():
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "result":
                    out.add(qual)
                    break
        return out

    @staticmethod
    def _lock_names(stmt: ast.stmt, suffix: str) -> List[str]:
        names = []
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                path = dotted_path(item.context_expr)
                if path is not None and \
                        last_component(path).endswith(suffix):
                    names.append(last_component(path))
        return names

    def _direct_acquires(self, project: Project,
                         suffix: str) -> Dict[str, Set[str]]:
        out: Dict[str, Set[str]] = {}
        for qual, fi in project.functions.items():
            got: Set[str] = set()
            for node in ast.walk(fi.node):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    got.update(self._lock_names(node, suffix))
            if got:
                out[qual] = got
        return out

    def _scan(self, project: Project, fi: FunctionInfo,
              body: List[ast.stmt], held: List[str], suffix: str,
              awaiting: Set[str], acquires: Dict[str, Set[str]],
              reach, findings: List[Finding],
              edges: Dict[str, Set[str]], edge_sites: Dict) -> None:
        for stmt in body:
            locks = self._lock_names(stmt, suffix)
            if locks:
                for new in locks:
                    for h in held:
                        if h == new:
                            findings.append(_finding(
                                self.id, fi, stmt,
                                f"re-acquisition of non-reentrant lock "
                                f"'{new}' while already held"))
                        else:
                            edges.setdefault(h, set()).add(new)
                            edge_sites.setdefault((h, new), (fi, stmt))
                self._scan(project, fi, stmt.body, held + locks, suffix,
                           awaiting, acquires, reach, findings, edges,
                           edge_sites)
                continue
            if held:
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    if isinstance(node.func, ast.Attribute) and \
                            node.func.attr == "result":
                        findings.append(_finding(
                            self.id, fi, node,
                            f"future awaited while holding "
                            f"'{held[-1]}'; await copy deps before "
                            f"taking the pool lock"))
                        continue
                    for callee in project.resolve_call(node, fi.module, fi):
                        r = reach(callee.qualname)
                        waits = r & awaiting
                        if waits:
                            findings.append(_finding(
                                self.id, fi, node,
                                f"call to {last_component(callee.qualname)} "
                                f"awaits a future "
                                f"({last_component(sorted(waits)[0])}) "
                                f"while '{held[-1]}' is held"))
                        for acq_qual in r:
                            for lock in acquires.get(acq_qual, ()):  #
                                if lock in held:
                                    findings.append(_finding(
                                        self.id, fi, node,
                                        f"call path into "
                                        f"{last_component(acq_qual)} "
                                        f"re-acquires '{lock}' already "
                                        f"held here"))
                                else:
                                    for h in held:
                                        edges.setdefault(h, set()).add(lock)
                                        edge_sites.setdefault(
                                            (h, lock), (fi, node))
            # recurse into nested blocks with the same held set
            for sub in self._sub_bodies(stmt):
                self._scan(project, fi, sub, held, suffix, awaiting,
                           acquires, reach, findings, edges, edge_sites)

    @staticmethod
    def _sub_bodies(stmt: ast.stmt) -> List[List[ast.stmt]]:
        out = []
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, attr, None)
            if isinstance(sub, list) and sub and \
                    isinstance(sub[0], ast.stmt):
                out.append(sub)
        for h in getattr(stmt, "handlers", []) or []:
            out.append(h.body)
        return out

    @staticmethod
    def _cycle_edges(edges: Dict[str, Set[str]]) -> List[Tuple[str, str]]:
        out = []
        for a, succs in edges.items():
            for b in succs:
                if a in edges.get(b, set()):
                    out.append((a, b))
        return out


# ---------------------------------------------------------------------------
# FS006 — whole-pool out-of-place write
# ---------------------------------------------------------------------------

class PoolOutOfPlaceWrite(Rule):
    """A pool attribute bound (outside ``__init__``, where the pool is
    allocated) to an out-of-place op over a pool — ``index_put``,
    ``scatter``, ``where``, ``clone``, ``cat``, ``+`` — materialises a
    pool-sized copy, and moves the pool a captured graph reads.  The
    port's pool writes are in place on the tensor ``PagedPools`` owns."""
    id = "FS006"
    title = "pool-out-of-place-write"

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        names = project.config.pool_attr_names
        for qual, fi in project.functions.items():
            if fi.name == "__init__":
                continue
            for node in ast.walk(fi.node):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)) or \
                        node.value is None or \
                        fi.module.function_for(node) is not fi:
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if not (isinstance(t, ast.Attribute) and t.attr in names):
                        continue
                    op = self._out_of_place_over_pool(node.value, project)
                    if op is not None:
                        findings.append(_finding(
                            self.id, fi, node,
                            f"'{dotted_path(t)}' is bound to an "
                            f"out-of-place {op} over the pool, a copy of "
                            f"the entire pool; write it in place through "
                            f"the staged swap path"))
        return findings

    @staticmethod
    def _out_of_place_over_pool(value: ast.expr,
                                project: Project) -> Optional[str]:
        names = project.config.pool_attr_names
        ops = project.config.out_of_place_ops

        def over_pool(expr: ast.expr) -> bool:
            for sub in ast.walk(expr):
                if isinstance(sub, (ast.Name, ast.Attribute)):
                    path = dotted_path(sub)
                    if path is not None and last_component(path) in names:
                        return True
            return False

        if isinstance(value, ast.BinOp):
            return "arithmetic" if over_pool(value) else None
        if isinstance(value, ast.Call):
            cn = call_name(value)
            bare = last_component(cn) if cn else (
                value.func.attr if isinstance(value.func, ast.Attribute)
                else None)
            if bare in ops and over_pool(value):
                return f"'{bare}'"
        return None


# ---------------------------------------------------------------------------
# FS007 — blocking call inside async def
# ---------------------------------------------------------------------------

class AsyncBlockingCall(Rule):
    """The front-end's asyncio server (DESIGN.md §11) multiplexes every
    connection over one event loop; a single blocking call — a thread
    sleep, a synchronous ``future.result()`` bridging the engine
    threads, a raw socket recv, a device wait — stalls token
    streaming for ALL clients.  Engine access must marshal through
    ``asyncio.wrap_future`` / the reader-writer streams instead.

    A call that is directly awaited is exempt: ``await ws.recv()``
    yields to the loop.  Deep device-value host-sync detection stays
    FS003's job; this rule names the explicit blocking entry points
    (``Config.async_blocking_calls`` / ``async_blocking_attrs``)."""
    id = "FS007"
    title = "async-blocking-call"

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        cfg = project.config
        for fi in project.functions.values():
            if not isinstance(fi.node, ast.AsyncFunctionDef):
                continue
            parents = fi.module.parents
            for call in _owned_calls(fi):
                if isinstance(parents.get(call), ast.Await):
                    continue
                path = dotted_path(call.func)
                if path is not None and (
                        path in cfg.async_blocking_calls
                        or any(path.endswith("." + c)
                               for c in cfg.async_blocking_calls)):
                    findings.append(_finding(
                        self.id, fi, call,
                        f"blocking call '{path}' inside an async def "
                        f"stalls the event loop for every connection; "
                        f"use the asyncio equivalent or move it off-loop"))
                    continue
                if isinstance(call.func, ast.Attribute) and \
                        call.func.attr in cfg.async_device_attrs:
                    findings.append(_finding(
                        self.id, fi, call,
                        f"blocking '.{call.func.attr}()' inside an async "
                        f"def waits for the device and stalls the event "
                        f"loop; run it off-loop (run_in_executor)"))
                    continue
                if isinstance(call.func, ast.Attribute) and \
                        call.func.attr in cfg.async_blocking_attrs:
                    findings.append(_finding(
                        self.id, fi, call,
                        f"blocking '.{call.func.attr}()' inside an async "
                        f"def stalls the event loop; bridge threads with "
                        f"asyncio.wrap_future / run_in_executor and use "
                        f"stream reader/writer APIs for sockets"))
        return findings


ALL_RULES: Tuple[type, ...] = (
    CapturedTensorRebind, GraphBucketBudget, HostSyncInHotPath,
    SwapThreadDiscipline, LockDiscipline, PoolOutOfPlaceWrite,
    AsyncBlockingCall,
)


def make_rules(only: Optional[Tuple[str, ...]] = None) -> List[Rule]:
    rules = [cls() for cls in ALL_RULES]
    if only:
        rules = [r for r in rules if r.id in only]
    return rules
