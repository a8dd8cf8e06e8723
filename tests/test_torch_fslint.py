"""fslint for the port (``src/repro_torch/analysis``) — fixture-driven
rule tests, rule by rule after ``tests/test_fslint.py``.

Each rule gets a positive (planted violation detected, in torch), a
negative (disciplined code stays clean), and a suppressed variant
(inline disable honoured).  Plus: receiver typing (a CUDA event's wait
under a lock is FS003, never FS005), baseline round-trip,
malformed-suppression reporting, the CLI contract, the self-run over
``src/repro_torch`` (the gate: zero new findings, every suppression with
a reason), the registries on the real tree, a planted ``.item()`` in a
copy of the decode runner, and the package importing with torch and jax
absent.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import Config, run_analysis
from repro_torch.analysis.baseline import Baseline
from repro_torch.analysis.callgraph import Project
from repro_torch.analysis.core import parse_suppressions
from repro_torch.analysis.driver import AnalysisResult
from torch_threads import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
CLI_KEYS = {"baselined", "exit", "jit_degrees", "new", "paths", "rules",
            "stale_baseline", "suppressed"}


def _run(tmp_path, sources, rules=None, **config):
    for name, text in sources.items():
        (tmp_path / name).write_text(text, encoding="utf-8")
    cfg = Config(rules=tuple(rules) if rules else None, **config)
    return run_analysis([str(tmp_path)], cfg, repo_root=str(tmp_path))


def _rules_of(result):
    return sorted({f.rule for f in result.findings})


# ---------------------------------------------------------------------------
# FS001 rebind of a graph-captured tensor
# ---------------------------------------------------------------------------

FS001_PRELUDE = """\
import torch


class _StepGraph:
    def __init__(self, step, tensors, stream):
        self.tensors = tensors


class Runner:
    def __init__(self):
        self._bt = torch.zeros(4, dtype=torch.int32)
        self._ctx = torch.zeros(4, dtype=torch.int32)
        self._graphs = {}

    def _tensors(self, pool):
        return (pool, self._bt, self._ctx)

    def _rebuild(self, n):
        self._graphs = {}              # drops every capture
        self._bt = torch.zeros(n, dtype=torch.int32)
        self._ctx = torch.zeros(n, dtype=torch.int32)

    def decode(self, views, pool):
        if 0 not in self._graphs:
            self._graphs[0] = _StepGraph(None, self._tensors(pool), None)
        return pool
"""


class TestFS001:
    def test_positive_rebound_captured_tensor(self, tmp_path):
        res = _run(tmp_path, {"m.py": FS001_PRELUDE + """
    def step(self, rows):
        self._bt = torch.as_tensor(rows)
"""}, rules=["FS001"])
        assert [f.rule for f in res.findings] == ["FS001"]
        assert "'self._bt'" in res.findings[0].message
        assert res.findings[0].qualname.endswith("Runner.step")

    def test_positive_pool_rebound_to_a_new_tensor(self, tmp_path):
        res = _run(tmp_path, {"m.py": FS001_PRELUDE + """

class Engine:
    def __init__(self, pools, runner):
        self.pools, self.runner = pools, runner

    def step(self, views):
        self.pools.gpu = self.runner.decode(views, self.pools.gpu.clone())
"""}, rules=["FS001"])
        assert [f.rule for f in res.findings] == ["FS001"]
        assert "the pool" in res.findings[0].message

    def test_positive_through_wrapper_returning_another_tensor(self, tmp_path):
        res = _run(tmp_path, {"m.py": FS001_PRELUDE + """

def grown(pool, extra):
    return extra


def step(pools, extra):
    pools.gpu = grown(pools.gpu, extra)
"""}, rules=["FS001"])
        assert [f.rule for f in res.findings] == ["FS001"]
        assert res.findings[0].qualname.endswith(".step")

    def test_negative_in_place_and_identity_rebinds(self, tmp_path):
        res = _run(tmp_path, {"m.py": FS001_PRELUDE + """
    def insert(self, pool, k):
        pool[0] = k
        return pool

    def prefill_insert(self, views, pool, k):
        pool = self.insert(pool, k)
        return pool

    def step(self, rows, vals):
        self._bt[rows] = vals
        self._ctx.copy_(vals)


class Engine:
    def __init__(self, pools, runner):
        self.pools, self.runner = pools, runner
        self.pools.gpu = torch.zeros(8)

    def step(self, views, k):
        self.pools.gpu = self.runner.decode(views, self.pools.gpu)
        self.pools.gpu = self.runner.prefill_insert(views, self.pools.gpu, k)
"""}, rules=["FS001"])
        assert res.findings == []

    def test_suppressed(self, tmp_path):
        res = _run(tmp_path, {"m.py": FS001_PRELUDE + """
    def step(self, rows):
        # fslint: disable=FS001(test fixture rebinds on purpose; no replay follows)
        self._bt = torch.as_tensor(rows)
"""}, rules=["FS001"])
        assert res.findings == []
        assert [f.rule for f in res.suppressed] == ["FS001"]


# ---------------------------------------------------------------------------
# FS002 graph-and-bucket budget
# ---------------------------------------------------------------------------

FS002_PRELUDE = """\
import torch


def _next_pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


def padded(x, n, real_len=0):
    return x[:n]
"""
FS002_KEYED = (("m.padded", ("n",), ("real_len",)),)


class TestFS002:
    def test_positive_unbucketed_shape_key(self, tmp_path):
        res = _run(tmp_path, {"m.py": FS002_PRELUDE + """

def decode(items):
    return padded(torch.zeros((4,)), n=len(items))
"""}, rules=["FS002"], keyed_functions=FS002_KEYED)
        assert [f.rule for f in res.findings] == ["FS002"]
        assert "shape-key arg 'n'" in res.findings[0].message

    def test_positive_unbucketed_tensor_shape(self, tmp_path):
        res = _run(tmp_path, {"m.py": FS002_PRELUDE + """

def step(items):
    return padded(torch.zeros((len(items),)), n=4)
"""}, rules=["FS002"], keyed_functions=FS002_KEYED)
        assert [f.rule for f in res.findings] == ["FS002"]
        assert "tensor arg" in res.findings[0].message

    def test_negative_bucketed_and_value_arg(self, tmp_path):
        res = _run(tmp_path, {"m.py": FS002_PRELUDE + """

def step(items):
    n = max(_next_pow2(len(items)), 4)
    return padded(torch.zeros((n,)), n=n, real_len=len(items))
"""}, rules=["FS002"], keyed_functions=FS002_KEYED)
        assert res.findings == []

    def test_cold_path_not_checked(self, tmp_path):
        res = _run(tmp_path, {"m.py": FS002_PRELUDE + """

def offline_eval(items):
    return padded(torch.zeros((4,)), n=len(items))
"""}, rules=["FS002"], keyed_functions=FS002_KEYED)
        assert res.findings == []

    def test_degrees_reported_for_audit(self, tmp_path):
        res = _run(tmp_path, {"m.py": FS002_PRELUDE + """

def step(items):
    n = _next_pow2(len(items))
    return padded(torch.zeros((n,)), n=n)
"""}, rules=["FS002"], keyed_functions=FS002_KEYED)
        (qual, deg), = res.jit_degrees.items()
        assert qual.endswith("padded") and deg == 1

    def test_suppressed(self, tmp_path):
        res = _run(tmp_path, {"m.py": FS002_PRELUDE + """

def step(items):
    # fslint: disable=FS002(bounded offline batch, at most 3 variants)
    return padded(torch.zeros((4,)), n=len(items))
"""}, rules=["FS002"], keyed_functions=FS002_KEYED)
        assert res.findings == []
        assert [f.rule for f in res.suppressed] == ["FS002"]


# ---------------------------------------------------------------------------
# FS003 host sync in hot path
# ---------------------------------------------------------------------------

class TestFS003:
    def test_positive_np_asarray_on_device(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
import numpy as np
import torch


def step(xs):
    dev = torch.as_tensor(xs, device="cuda") * 2
    return np.asarray(dev)[0]
"""}, rules=["FS003"])
        assert [f.rule for f in res.findings] == ["FS003"]
        assert "np.asarray" in res.findings[0].message

    def test_positive_int_item_and_branch(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
import torch


def step(xs):
    dev = torch.sum(torch.as_tensor(xs))
    a = int(dev)
    b = dev.item()
    if dev > 0:
        a += 1
    return a + b
"""}, rules=["FS003"])
        assert len(res.findings) == 3
        assert any("int()" in f.message for f in res.findings)
        assert any(".item()" in f.message for f in res.findings)
        assert any("branching" in f.message for f in res.findings)

    def test_positive_copies_and_device_waits(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
import torch
import torch.nn.functional as F


def decode(x, ev):
    y = F.softmax(x.float(), dim=-1)
    a = y.tolist()
    b = y.cpu()
    c = y.argmax(-1).numpy()
    torch.cuda.synchronize()
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return a, b, c
"""}, rules=["FS003"])
        msgs = sorted(f.message.split(" inside ")[0] for f in res.findings)
        assert len(msgs) == 5, msgs
        for what in (".tolist()", ".cpu()", ".numpy()",
                     "torch.cuda.synchronize()", ".synchronize() blocks"):
            assert any(what in m for m in msgs), (what, msgs)

    def test_positive_device_attr_ring_buffer(self, tmp_path):
        # device values parked in a container attribute keep their
        # taint when read back in a later step (deferred-sync pattern)
        res = _run(tmp_path, {"m.py": """\
import numpy as np
import torch


class Runner:
    def __init__(self):
        self._pending = []

    def decode(self, xs):
        nxt = torch.as_tensor(xs) + 1
        self._pending.append(nxt)

    def step(self):
        for nxt in self._pending:
            print(np.asarray(nxt))
        if not self._pending:      # host len check: NOT a sync
            return
"""}, rules=["FS003"])
        assert [f.rule for f in res.findings] == ["FS003"]

    def test_negative_host_values_and_cold_path(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
import numpy as np
import torch


def step(xs, ev):
    host = np.asarray(xs)          # unknown input: no device taint
    pinned = torch.from_numpy(host)
    n = int(pinned.shape[0]) + int(host[0])
    if torch.is_grad_enabled() or not ev.query():
        n += 1
    return n


def offline(xs):
    dev = torch.as_tensor(xs, device="cuda")
    return dev.cpu()               # not reachable from a hot root
"""}, rules=["FS003"])
        assert res.findings == []

    def test_allowlisted_staged_sync_point(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
import torch


class PagedPools:
    def copy_in_staged(self, blocks):
        self.gpu[blocks] = 0
        torch.cuda.synchronize()


def step(pools, blocks):
    pools.copy_in_staged(blocks)
"""}, rules=["FS003"])
        assert res.findings == []

    def test_suppressed(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
import numpy as np
import torch


def step(xs):
    dev = torch.as_tensor(xs) * 2
    # fslint: disable=FS003(documented deferred sync point)
    return np.asarray(dev)[0]
"""}, rules=["FS003"])
        assert res.findings == []
        assert [f.rule for f in res.suppressed] == ["FS003"]


# ---------------------------------------------------------------------------
# receiver typing: an event or stream wait is a device sync, not a future
# ---------------------------------------------------------------------------

RECEIVER_FIXTURE = """\
import threading
from dataclasses import dataclass
from typing import Optional

import torch


class SwapManager:
    def synchronize(self, task):
        task.future.result()       # a project method that awaits a future


@dataclass
class Staged:
    done: Optional[torch.cuda.Event] = None


class Runner:
    def __init__(self):
        self._pool_lock = threading.Lock()
        self._ready = (torch.cuda.Event() if torch.cuda.is_available()
                       else None)

    def flush(self):
        self._ready.synchronize()

    def wait(self, after: Optional[torch.cuda.Event], staged: Staged):
        after.synchronize()
        staged.done.synchronize()

    def step(self, staged):
        with self._pool_lock:
            self.flush()
            self.wait(None, staged)
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
            torch.cuda.current_stream().synchronize()
"""


class TestReceiverTyping:
    def test_event_wait_under_lock_is_fs003_never_fs005(self, tmp_path):
        res = _run(tmp_path, {"m.py": RECEIVER_FIXTURE},
                   rules=["FS003", "FS005"])
        assert _rules_of(res) == ["FS003"]
        where = sorted(f.qualname.rsplit(".", 1)[-1] for f in res.findings)
        assert where == ["flush", "step", "step", "wait", "wait"], where

    def test_reference_linter_took_it_for_a_future(self, tmp_path):
        """The reference's name-based resolution sends every
        ``x.synchronize()`` to ``SwapManager.synchronize``: the false
        FS005 the port's typing removes."""
        from repro.analysis import Config as RefConfig
        from repro.analysis import run_analysis as ref_run
        (tmp_path / "m.py").write_text(RECEIVER_FIXTURE, encoding="utf-8")
        res = ref_run([str(tmp_path)], RefConfig(rules=("FS005",)),
                      repo_root=str(tmp_path))
        assert res.findings and all(f.rule == "FS005" and
                                    "synchronize" in f.message
                                    for f in res.findings)

    def test_untyped_receiver_still_resolves(self, tmp_path):
        # ``swap.synchronize(task)`` on a project object keeps the
        # conservative fallback: the future wait under the lock is found
        res = _run(tmp_path, {"m.py": RECEIVER_FIXTURE + """

def drain(runner, swap, task):
    with runner._pool_lock:
        swap.synchronize(task)
"""}, rules=["FS005"])
        assert [f.rule for f in res.findings] == ["FS005"]
        assert res.findings[0].qualname.endswith("drain")


# ---------------------------------------------------------------------------
# FS004 swap-plane thread discipline
# ---------------------------------------------------------------------------

FS004_COMMON = """\
from concurrent.futures import ThreadPoolExecutor


class Pools:
    def copy_in_staged(self, blocks, slab):
        self.gpu[:, blocks] = slab          # in-place pool write

    def copy_out_staged(self, blocks):
        return self.gpu[:, blocks].to("cpu", non_blocking=True)


def make_task(pools, task, direction):
    if direction == "out":
        copy_fn = lambda: pools.copy_out_staged([1])
    else:
        copy_fn = lambda: pools.copy_in_staged([1], None)
    task.copy_fn = copy_fn
    return task
"""


class TestFS004:
    def test_positive_unguarded_submit(self, tmp_path):
        res = _run(tmp_path, {"m.py": FS004_COMMON + """

class Manager:
    def __init__(self):
        self._executor = ThreadPoolExecutor(1)

    def dispatch(self, task, direction):
        task.future = self._executor.submit(self._run, task)

    def _run(self, task):
        task.copy_fn()
"""}, rules=["FS004"])
        assert [f.rule for f in res.findings] == ["FS004"]
        assert "copy_in_staged" in res.findings[0].message

    def test_positive_listed_scatter_wrapper(self, tmp_path):
        # a pool writer named in Config.pool_writers counts even where
        # its body shows no write (a kernel writes through a pointer)
        res = _run(tmp_path, {"ops.py": """\
def scatter_swap_runs(pool, slab, runs):
    return pool
""", "m.py": """\
from concurrent.futures import ThreadPoolExecutor

import ops


def restore(pool, slab):
    return ops.scatter_swap_runs(pool, slab, [(0, 1)])


class Manager:
    def __init__(self):
        self._executor = ThreadPoolExecutor(1)

    def dispatch(self, pool, slab):
        return self._executor.submit(restore, pool, slab)
"""}, rules=["FS004"])
        assert [f.rule for f in res.findings] == ["FS004"]
        assert "scatter_swap_runs" in res.findings[0].message

    def test_negative_direction_guarded_submit(self, tmp_path):
        res = _run(tmp_path, {"m.py": FS004_COMMON + """

class Manager:
    def __init__(self):
        self._executor = ThreadPoolExecutor(1)

    def dispatch(self, task, direction, asynchronous):
        if asynchronous and direction == "out":
            task.future = self._executor.submit(self._run, task)
        else:
            self._run(task)

    def _run(self, task):
        task.copy_fn()
"""}, rules=["FS004"])
        assert res.findings == []

    def test_suppressed(self, tmp_path):
        res = _run(tmp_path, {"m.py": FS004_COMMON + """

class Manager:
    def __init__(self):
        self._executor = ThreadPoolExecutor(1)

    def dispatch(self, task, direction):
        # fslint: disable=FS004(single-threaded executor used as a queue)
        task.future = self._executor.submit(self._run, task)

    def _run(self, task):
        task.copy_fn()
"""}, rules=["FS004"])
        assert res.findings == []
        assert [f.rule for f in res.suppressed] == ["FS004"]


# ---------------------------------------------------------------------------
# FS005 lock discipline (framework-free: the reference's fixtures, which
# tests/test_torch_fslint_parity.py also holds to the reference's findings)
# ---------------------------------------------------------------------------

class TestFS005:
    def test_positive_await_under_lock(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
import threading


class M:
    def __init__(self):
        self._pool_lock = threading.Lock()

    def bad(self, task):
        with self._pool_lock:
            task.future.result()
"""}, rules=["FS005"])
        assert [f.rule for f in res.findings] == ["FS005"]
        assert "_pool_lock" in res.findings[0].message

    def test_positive_lock_order_cycle(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
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
"""}, rules=["FS005"])
        assert res.findings and \
            all("cycle" in f.message for f in res.findings)

    def test_negative_await_before_lock(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
import threading


class M:
    def __init__(self):
        self._pool_lock = threading.Lock()

    def good(self, task, deps):
        for d in deps:
            d.result()
        with self._pool_lock:
            task.run()
"""}, rules=["FS005"])
        assert res.findings == []

    def test_suppressed(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
import threading


class M:
    def __init__(self):
        self._pool_lock = threading.Lock()

    def waived(self, task):
        with self._pool_lock:
            # fslint: disable=FS005(future is already done at this point)
            task.future.result()
"""}, rules=["FS005"])
        assert res.findings == []
        assert [f.rule for f in res.suppressed] == ["FS005"]


# ---------------------------------------------------------------------------
# FS006 whole-pool out-of-place write
# ---------------------------------------------------------------------------

FS006_DIRTY = """\
import torch


class P:
    def copy_in(self, data, blocks):
        self.gpu = self.gpu.index_put((blocks,), data)
"""


class TestFS006:
    def test_positive_whole_pool_copies(self, tmp_path):
        res = _run(tmp_path, {"m.py": FS006_DIRTY + """
    def clear(self, mask):
        self.gpu = torch.where(mask, self.gpu, 0)

    def bump(self, x):
        self.gpu = self.gpu + x

    def snapshot_back(self):
        self.pool = self.gpu.clone()
"""}, rules=["FS006"])
        assert [f.rule for f in res.findings] == ["FS006"] * 4
        assert "'index_put'" in res.findings[0].message

    def test_negative_in_place_init_and_non_pool(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
import torch


class P:
    def __init__(self, shape):
        self.gpu = torch.zeros(shape)          # the allocation
        self.bt = torch.zeros(4)

    def copy_in(self, data, blocks):
        self.gpu[:, blocks] = data             # in place
        self.gpu.index_copy_(1, blocks, data)

    def table_update(self, rows):
        self.bt = self.bt.clone()              # not a pool
"""}, rules=["FS006"])
        assert res.findings == []

    def test_suppressed(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
import torch


class P:
    def write_debug(self, data, blocks):
        # fslint: disable=FS006(host-side debug utility)
        self.gpu = self.gpu.index_put((blocks,), data)
"""}, rules=["FS006"])
        assert res.findings == []
        assert [f.rule for f in res.suppressed] == ["FS006"]


# ---------------------------------------------------------------------------
# suppression parsing / FS000
# ---------------------------------------------------------------------------

class TestSuppressions:
    def test_reason_required(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
import torch


def step(xs):
    dev = torch.as_tensor(xs)
    # fslint: disable=FS003
    return dev.item()
"""})
        rules = _rules_of(res)
        assert "FS000" in rules          # malformed suppression reported
        assert "FS003" in rules          # and the finding is NOT waived

    def test_multi_clause_parsing(self):
        sup = parse_suppressions(
            "x = 1  # fslint: disable=FS001(a b), FS003(c)\n")
        assert sup.by_line[1] == {"FS001": "a b", "FS003": "c"}
        assert sup.covers(1, "FS001") and sup.covers(2, "FS003")
        assert not sup.covers(1, "FS002") and not sup.covers(3, "FS001")

    def test_fs000_cannot_be_disabled(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
# fslint: disable=FS000(nope)
x = 1
"""})
        assert "FS000" in _rules_of(res)


# ---------------------------------------------------------------------------
# baseline round-trip
# ---------------------------------------------------------------------------

class TestBaseline:
    def test_round_trip_and_stale(self, tmp_path):
        res = _run(tmp_path, {"m.py": FS006_DIRTY}, rules=["FS006"])
        assert len(res.findings) == 1

        bl_path = tmp_path / "baseline.json"
        Baseline(bl_path).save(res.findings)

        # reload: the finding is now grandfathered
        bl2 = Baseline.load(bl_path)
        new, known, stale = bl2.split(res.findings)
        assert new == [] and len(known) == 1 and stale == []

        # fingerprints survive line shifts (edits above the finding)
        shifted = _run(tmp_path, {
            "m.py": "# a new leading comment\n" + FS006_DIRTY},
            rules=["FS006"])
        new, known, stale = bl2.split(shifted.findings)
        assert new == [] and len(known) == 1 and stale == []

        # fixing the violation leaves a prunable stale entry, not a gate
        clean = _run(tmp_path, {"m.py": "x = 1\n"}, rules=["FS006"])
        new, known, stale = bl2.split(clean.findings)
        assert new == [] and known == [] and len(stale) == 1


# ---------------------------------------------------------------------------
# FS007 blocking call in async def
# ---------------------------------------------------------------------------

class TestFS007:
    def test_positive_time_sleep_in_async(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
import time


async def handler(req):
    time.sleep(0.1)
    return req
"""}, rules=["FS007"])
        assert [f.rule for f in res.findings] == ["FS007"]
        assert "time.sleep" in res.findings[0].message

    def test_positive_future_result_and_socket_recv(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
async def pump(fut, sock):
    data = sock.recv(4096)
    return fut.result(), data
"""}, rules=["FS007"])
        assert len(res.findings) == 2
        assert all(f.rule == "FS007" for f in res.findings)

    def test_positive_device_sync_in_async(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
import torch


async def stream(out):
    torch.cuda.synchronize()
    return out.item(), out.cpu()
"""}, rules=["FS007"])
        assert [f.rule for f in res.findings] == ["FS007"] * 3
        assert "torch.cuda.synchronize" in res.findings[0].message
        assert "waits for the device" in res.findings[1].message

    def test_negative_sync_def_and_awaited_calls(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
import asyncio
import time

import torch


def worker_thread(fut, out):
    time.sleep(0.1)            # fine: not on the event loop
    torch.cuda.synchronize()
    return fut.result(), out.item()


async def handler(rep, ws):
    data = await ws.recv()     # directly awaited: yields to the loop
    res = await asyncio.wrap_future(rep.call())
    await asyncio.sleep(0.01)
    return data, res
"""}, rules=["FS007"])
        assert res.findings == []

    def test_suppressed(self, tmp_path):
        res = _run(tmp_path, {"m.py": """\
import torch


async def shutdown():
    # fslint: disable=FS007(final drain, loop is exiting anyway)
    torch.cuda.synchronize()
"""}, rules=["FS007"])
        assert res.findings == []
        assert [f.rule for f in res.suppressed] == ["FS007"]


# ---------------------------------------------------------------------------
# CLI contract
# ---------------------------------------------------------------------------

def _cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=cwd, env=env)


class TestCLI:
    def test_dirty_fixture_exits_1_with_json(self, tmp_path):
        (tmp_path / "m.py").write_text(FS006_DIRTY, encoding="utf-8")
        proc = _cli(["m.py", "--format", "json", "--baseline",
                     "absent.json"], cwd=tmp_path)
        assert proc.returncode == 1, proc.stderr
        payload = json.loads(proc.stdout)
        assert set(payload) == CLI_KEYS
        assert payload["exit"] == 1
        assert [f["rule"] for f in payload["new"]] == ["FS006"]

    def test_clean_fixture_exits_0(self, tmp_path):
        (tmp_path / "m.py").write_text("x = 1\n", encoding="utf-8")
        proc = _cli(["m.py"], cwd=tmp_path)
        assert proc.returncode == 0, proc.stdout + proc.stderr

    def test_unknown_rule_exits_2(self, tmp_path):
        (tmp_path / "m.py").write_text("x = 1\n", encoding="utf-8")
        proc = _cli(["m.py", "--rule", "FS999"], cwd=tmp_path)
        assert proc.returncode == 2

    def test_missing_path_exits_2(self, tmp_path):
        proc = _cli(["does_not_exist_dir"], cwd=tmp_path)
        assert proc.returncode == 2

    def test_planted_item_in_decode_runner_exits_1(self, tmp_path):
        """A copy of the port's decode runner with a ``.item()`` on the
        step's context tensor planted in ``flush`` (the decode step's
        deferred sync): the CLI finds it."""
        src = (PORT / "core" / "decode_runner.py").read_text()
        anchor = "        rows_hist = self._pending\n"
        assert anchor in src
        dirty = src.replace(anchor, anchor + "        n = self._ctx.max().item()\n")
        (tmp_path / "decode_runner.py").write_text(src)
        clean = _cli(["decode_runner.py", "--format", "json"], cwd=tmp_path)
        assert clean.returncode == 0, clean.stdout[-2000:]
        (tmp_path / "decode_runner.py").write_text(dirty)
        proc = _cli(["decode_runner.py", "--format", "json"], cwd=tmp_path)
        assert proc.returncode == 1, proc.stdout[-2000:]
        new = json.loads(proc.stdout)["new"]
        assert [(f["rule"], f["qualname"].rsplit(".", 1)[-1])
                for f in new] == [("FS003", "flush")]
        assert ".item()" in new[0]["message"]

    def test_imports_and_runs_without_torch_or_jax(self, tmp_path):
        (tmp_path / "m.py").write_text(FS006_DIRTY, encoding="utf-8")
        code = (
            "import sys\n"
            "sys.modules['torch'] = sys.modules['jax'] = None\n"
            "from repro_torch.analysis import Config, run_analysis\n"
            f"r = run_analysis([{str(tmp_path)!r}], repo_root="
            f"{str(tmp_path)!r})\n"
            "assert [f.rule for f in r.findings] == ['FS006'], r.findings\n"
            "assert 'repro' not in sys.modules\n"
            "print('ok')\n")
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
            proc.stderr[-2000:]


# ---------------------------------------------------------------------------
# the gate over src/repro_torch, and the registries on the real tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_run():
    return run_analysis([str(PORT)], repo_root=str(REPO))


class TestSelfRun:
    def test_port_tree_is_clean(self, port_run):
        """The gate: zero new findings on src/repro_torch, with no
        baseline entry (new code never enters the baseline)."""
        assert port_run.findings == [], \
            "\n".join(f.render() for f in port_run.findings)
        # the documented sync points, each waived at its site
        waived = sorted((f.rule, f.qualname.rsplit(".", 1)[-1])
                        for f in port_run.suppressed)
        assert waived == [("FS003", "_prefill_emit"), ("FS003", "flush"),
                          ("FS003", "flush")], waived

    def test_every_suppression_has_a_reason(self, port_run):
        for mod in port_run.project.modules.values():
            assert mod.suppressions.malformed == [], mod.rel_path
            for clauses in mod.suppressions.by_line.values():
                assert all(reason.strip() for reason in clauses.values())

    def test_registries_see_the_hot_path(self, port_run):
        """The hot set, the five audit rows, the graph captures, the
        identity returns and the receiver typing must keep seeing the
        real serving path — if these disappear, the rules have gone
        blind."""
        from repro_torch.launch.dryrun import AUDIT_ROWS
        p = port_run.project
        for suffix in ("core.serving.ServingEngine.step",
                       "core.decode_runner.DecodeRunner.decode",
                       "models.paged.paged_decode_step_device",
                       "cache.paged.PagedPools.copy_out_staged"):
            assert any(q.endswith(suffix) for q in p.hot), suffix
        for suffix in AUDIT_ROWS:
            assert any(q.endswith(suffix) for q in port_run.jit_degrees), \
                suffix
        assert p.captured_attrs[("repro_torch.core.decode_runner",
                                 "DecodeRunner")] == {
            "_bt", "_ctx", "_tok", "_active", "_keys", "_sampling"}
        assert any(q.endswith("DecodeRunner._rebuild")
                   for q in p.recapturing)
        for suffix in ("kernels.ops.scatter_swap_runs",
                       "kernels.ops.insert_prefill",
                       "core.decode_runner.DecodeRunner.decode",
                       "core.decode_runner.DecodeRunner.prefill_insert"):
            (q,) = [q for q in p.returned_params if q.endswith(suffix)]
            assert len(p.returned_params[q]) == 1, q
        flush = "repro_torch.core.decode_runner.DecodeRunner.flush"
        assert not any(c.endswith("SwapManager.synchronize")
                       for c in p.callees(flush))
        assert not any(f.rule == "FS005" for f in port_run.suppressed)

    def test_variant_bound_shape(self):
        assert AnalysisResult.variant_bound(0, 1024) == 13 ** 2
        assert AnalysisResult.variant_bound(3, 1024) == 13 ** 3
        assert AnalysisResult.variant_bound(2, 2048) == 14 ** 2


def test_project_indexes_a_copied_tree_the_same(tmp_path):
    """Module names follow a ``src`` directory wherever it sits, so a
    copy of the tree indexes to the same qualnames."""
    shutil.copytree(PORT / "kernels", tmp_path / "src" / "repro_torch"
                    / "kernels")
    a = Project([PORT / "kernels"], REPO, Config())
    b = Project([tmp_path / "src" / "repro_torch" / "kernels"], tmp_path,
                Config())
    assert set(a.functions) == set(b.functions)
    assert a.keyed_specs.keys() == b.keyed_specs.keys()
