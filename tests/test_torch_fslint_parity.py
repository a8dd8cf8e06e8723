"""The port's fslint (``repro_torch.analysis``) against the reference's
(``repro.analysis``, stdlib-only: no jax is imported) on the same inputs.

  * the reference's framework-free fixtures — FS000, FS005, FS007 (those
    that call no JAX API), suppression parsing and a baseline round
    trip — give identical ``Finding`` lists (rule, path, line, col,
    qualname, message) and fingerprints in both packages;
  * over ``src/repro``, both packages' ``Project`` give the same function
    set, call edges and hot set.  The port's ``Config`` is retargeted at
    the reference's conventions for that (its ``jax.jit`` alias wrappers
    and SPMD signature wrappers, ``Config.alias_wrappers`` /
    ``signature_wrappers``); its receiver typing is on, and the edges it
    changes in that tree are listed in ``RECEIVER_TYPED_EDGES``.
"""
from pathlib import Path

import pytest

from repro.analysis import Config as RefConfig
from repro.analysis import run_analysis as ref_run
from repro.analysis.baseline import Baseline as RefBaseline
from repro.analysis.callgraph import Project as RefProject
from repro.analysis.core import parse_suppressions as ref_parse
from repro_torch.analysis import Config, run_analysis
from repro_torch.analysis.baseline import Baseline
from repro_torch.analysis.callgraph import Project
from repro_torch.analysis.core import parse_suppressions
from torch_threads import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]

# the reference's fixtures (tests/test_fslint.py) that call no JAX API,
# by rule: (name, source, rules run)
FIXTURES = {
    "fs005_await_under_lock": ("""\
import threading


class M:
    def __init__(self):
        self._pool_lock = threading.Lock()

    def bad(self, task):
        with self._pool_lock:
            task.future.result()
""", ("FS005",)),
    "fs005_transitive_await": ("""\
import threading


class M:
    def __init__(self):
        self._pool_lock = threading.Lock()

    def waiter(self, task):
        task.future.result()

    def bad(self, task):
        with self._pool_lock:
            self.waiter(task)
""", ("FS005",)),
    "fs005_lock_order_cycle": ("""\
import threading


class M:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()

    def f1(self):
        with self._a_lock:
            with self._b_lock:
                pass

    def f2(self):
        with self._b_lock:
            with self._a_lock:
                pass
""", ("FS005",)),
    "fs005_await_before_lock": ("""\
import threading


class M:
    def __init__(self):
        self._pool_lock = threading.Lock()

    def good(self, task, deps):
        for d in deps:
            d.result()
        with self._pool_lock:
            task.run()
""", ("FS005",)),
    "fs005_suppressed": ("""\
import threading


class M:
    def __init__(self):
        self._pool_lock = threading.Lock()

    def waived(self, task):
        with self._pool_lock:
            # fslint: disable=FS005(future is already done at this point)
            task.future.result()
""", ("FS005",)),
    "fs007_time_sleep": ("""\
import time


async def handler(req):
    time.sleep(0.1)
    return req
""", ("FS007",)),
    "fs007_result_and_recv": ("""\
async def pump(fut, sock):
    data = sock.recv(4096)
    return fut.result(), data
""", ("FS007",)),
    "fs007_sync_def_and_awaited": ("""\
import asyncio
import time


def worker_thread(fut):
    time.sleep(0.1)            # fine: not on the event loop
    return fut.result()


async def handler(rep, ws):
    data = await ws.recv()     # directly awaited: yields to the loop
    res = await asyncio.wrap_future(rep.call())
    await asyncio.sleep(0.01)
    return data, res
""", ("FS007",)),
    "fs007_suppressed": ("""\
import time


async def shutdown():
    # fslint: disable=FS007(final drain, loop is exiting anyway)
    time.sleep(0.01)
""", ("FS007",)),
    "fs000_cannot_be_disabled": ("""\
# fslint: disable=FS000(nope)
x = 1
""", None),
    "fs000_malformed_clause": ("""\
import threading


class M:
    def __init__(self):
        self._pool_lock = threading.Lock()

    def bad(self, task):
        with self._pool_lock:
            # fslint: disable=FS005
            task.future.result()
""", None),
}

# edges of src/repro that the port's receiver typing removes (none: the
# reference binds no torch.cuda object)
RECEIVER_TYPED_EDGES = set()


def _rows(findings):
    return [(f.rule, f.path, f.line, f.col, f.qualname, f.message,
             f.fingerprint()) for f in findings]


def _both(tmp_path, source, rules):
    (tmp_path / "m.py").write_text(source, encoding="utf-8")
    ref = ref_run([str(tmp_path)], RefConfig(rules=rules),
                  repo_root=str(tmp_path))
    port = run_analysis([str(tmp_path)], Config(rules=rules),
                        repo_root=str(tmp_path))
    return ref, port


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_findings_equal_on_framework_free_fixtures(tmp_path, name):
    source, rules = FIXTURES[name]
    ref, port = _both(tmp_path, source, rules)
    assert _rows(port.findings) == _rows(ref.findings)
    assert _rows(port.suppressed) == _rows(ref.suppressed)
    assert ref.findings or ref.suppressed or name.endswith(
        ("await_before_lock", "sync_def_and_awaited"))


@pytest.mark.parametrize("text", [
    "x = 1  # fslint: disable=FS001(a b), FS003(c)\n",
    "x = 1  # fslint: disable=FS003\n",
    "y = 2\n# fslint: disable=FS005(ok),FS007( spaced )\nz = 3\n",
    "# fslint: disable=FS000(nope)\n",
    "w = 0  # fslint: disable=FS004(a) FS006(b)\n",
])
def test_suppression_parsing_equal(text):
    a, b = ref_parse(text), parse_suppressions(text)
    assert (b.by_line, b.malformed) == (a.by_line, a.malformed)


def test_baseline_files_equal(tmp_path):
    """Both packages' baselines of the same findings are the same file,
    and each splits the other's findings alike."""
    source, rules = FIXTURES["fs005_transitive_await"]
    ref, port = _both(tmp_path, source, rules)
    RefBaseline(tmp_path / "ref.json").save(ref.findings)
    Baseline(tmp_path / "port.json").save(port.findings)
    assert (tmp_path / "ref.json").read_text() == \
        (tmp_path / "port.json").read_text()
    new, known, stale = Baseline.load(tmp_path / "ref.json").split(
        port.findings)
    assert new == [] and len(known) == len(ref.findings) and stale == []
    new, known, stale = RefBaseline.load(tmp_path / "port.json").split(
        ref.findings)
    assert new == [] and len(known) == len(port.findings) and stale == []


def test_projects_equal_over_the_reference_tree():
    tree = [REPO / "src" / "repro"]
    ref = RefProject(tree, REPO, RefConfig())
    port = Project(tree, REPO, Config(
        alias_wrappers=("jax.jit", "jit"),
        signature_wrappers=("shard_map", "jax.experimental.shard_map."
                            "shard_map", "shmap", "pjit",
                            "jax.experimental.pjit.pjit",
                            "functools.partial", "partial")))
    assert set(port.functions) == set(ref.functions)
    assert {q: fi.qualname for q, fi in port.functions.items()} == \
        {q: fi.qualname for q, fi in ref.functions.items()}
    ref_edges = {(a, b) for a in ref.functions for b in ref.callees(a)}
    port_edges = {(a, b) for a in port.functions for b in port.callees(a)}
    assert ref_edges - port_edges == RECEIVER_TYPED_EDGES
    assert port_edges - ref_edges == set()
    assert port.hot == ref.hot
    assert port.bucketing_sources == ref.bucketing_sources
    assert len(port.hot) > 100
