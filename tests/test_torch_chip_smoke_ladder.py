"""chip_smoke.py's ``ladder`` phase on the CPU, at smoke size:
``scripts/ladder_probe.py --device cpu`` (the reduced mistral-nemo-12b,
the kernels' plain versions) with ``jax`` blocked, serving the engine
phase's workload under the paper's four policies; the moved-KV watcher
catches a corrupted swap either way; the background fairness example's
lines are read as chip_smoke reads them.  One of the files
``tests/test_torch_chip_smoke_*.py``, split by phase."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
from repro_torch.cache.paged import PagedPools, PoolSpec  # noqa: E402
from repro_torch.launch.scenarios import POLICY_ORDER  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
PROBE = os.path.join(ROOT, "scripts", "ladder_probe.py")


@pytest.fixture(scope="module")
def ladder():
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.argv = ['ladder_probe.py', '--device', 'cpu']\n"
            f"runpy.run_path({PROBE!r}, run_name='__main__')\n"
            "assert not any(m == 'repro' or m.startswith('repro.')\n"
            "               for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = r.stdout.splitlines()[-1]
    assert line.startswith('{"phase": "ladder"')
    return json.loads(line)


def test_ladder_phase_serves_every_policy(ladder):
    assert ladder["arch"] == "mistral-nemo-12b-smoke"
    assert ladder["device"] == "cpu" and ladder["profiled"] is None
    assert list(ladder["policies"]) == POLICY_ORDER
    for pol, r in ladder["policies"].items():
        assert min(r["swap_ops"].values()) > 0, pol
        assert min(r["blocks_moved"].values()) > 0, pol
        moved = r["moved_kv_blocks_checked"]
        assert moved["out_blocks"] > 0 and moved["in_blocks"] > 0, pol
        assert r["copy_retries"] == r["copy_failures"] == 0
        assert r["greedy_generated"] == r["greedy_within_near_tie"] \
            == 8 * 2 * 32
        assert r["greedy_max_gap"] < ladder["tolerance"]
        assert set(r["host_s_by_method"]) == set(chip_smoke.LADDER_METHODS)
        # the plain versions run on the CPU: no kernel launches to count
        assert set(r["launches"].values()) == {0}
    # block groups cut the operations, reuse the bytes swapped out
    ops = {p: sum(r["swap_ops"].values())
           for p, r in ladder["policies"].items()}
    assert ops["vllm"] > 5 * ops["+dbg"]
    out = {p: r["blocks_moved"]["out"] for p, r in ladder["policies"].items()}
    assert out["+dbg+reuse"] < out["+dbg"]
    assert len(ladder["streams"]) == 6
    for pair in ladder["streams"].values():
        assert all(gap < ladder["tolerance"] for _, gap in pair["parting_at"])
    assert ladder["tolerance"] == max(chip_smoke.NEAR_TIE,
                                      ladder["dense_spread"])
    assert ladder["near_tie_share"] == chip_smoke.LADDER_NEAR_TIE_SHARE


def _pools():
    spec = PoolSpec(n_layers=2, n_kv_heads=2, head_dim=8, block_size=4,
                    num_gpu_blocks=12, num_cpu_blocks=12)
    pools = PagedPools(spec, device="cpu")
    g = torch.Generator().manual_seed(0)
    pools.gpu.copy_(torch.randn(pools.gpu.shape, generator=g))
    return pools


def test_watch_moved_kv_holds_swaps_both_ways():
    pools = _pools()
    seen = chip_smoke.watch_moved_kv(pools)
    pools.copy_out_staged([(1, 3), (7, 2)], [0, 1, 2, 3, 4])
    pools.copy_in_staged([0, 1, 2], [(9, 3)])
    assert seen == {"out_blocks": 5, "in_blocks": 3}


@pytest.mark.parametrize("direction", ["out", "in"])
def test_watch_moved_kv_catches_a_corrupt_swap(direction, monkeypatch):
    """A swap whose copy lands one wrong byte fails the watcher."""
    pools = _pools()
    if direction == "out":
        real = pools.copy_out_staged

        def corrupt(runs, cpu_ids, **k):
            real(runs, cpu_ids, **k)
            pools.cpu[1, 0, cpu_ids[-1], 2, 1, 3] ^= np.uint16(1)
        pools.copy_out_staged = corrupt
    else:
        real = pools.copy_in_staged

        def corrupt(cpu_ids, runs, *a, **k):
            real(cpu_ids, runs, *a, **k)
            pools.gpu[0, 1, runs[0][0], 0, 0, 0] += 1
        pools.copy_in_staged = corrupt
    chip_smoke.watch_moved_kv(pools)
    with pytest.raises(AssertionError, match="bytes differ"):
        if direction == "out":
            pools.copy_out_staged([(2, 2)], [5, 6])
        else:
            pools.copy_in_staged([0, 1], [(4, 2)])


def _background(stdout: str, code: int = 0):
    script = f"import sys; sys.stdout.write({stdout!r}); sys.exit({code})"
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, chip_smoke.watch_exit(proc, 0.0)


LADDER_LINES = """policy             p95 TTFT     p99 TTFT    p99.9 TBT    tok/s  swap ops     stall
vllm                 2198 ms       5713 ms       9891 ms    225.8    175168    29.1s
+dbg                 2409 ms       6141 ms       7189 ms    233.1     14720    11.1s
+dbg+reuse           1282 ms       2892 ms       2567 ms    268.5     10769     6.5s
fastswitch           1233 ms       2752 ms       2489 ms    272.1     11311     4.1s
"""


def test_fairness_example_read_as_chip_smoke_reads_it():
    got = chip_smoke.check_fairness_example(_background(LADDER_LINES))
    assert list(got["rows"]) == POLICY_ORDER
    assert got["rows"]["vllm"]["swap_ops"] == 175168
    assert got["rows"]["fastswitch"]["stall_s"] == 4.1
    with pytest.raises(AssertionError, match="rows for"):
        chip_smoke.check_fairness_example(_background(
            "\n".join(LADDER_LINES.splitlines()[:-1])))
    with pytest.raises(AssertionError, match="exited 3"):
        chip_smoke.check_fairness_example(_background(LADDER_LINES, 3))


def test_profile_window_records_the_window_iterations():
    """``profile_window`` starts the profiler just before iteration 30
    and stops it just after iteration 69, each behind a synchronise; a
    run that ends inside the window is closed by ``close``, once."""
    class Prof:
        def __init__(self):
            self.calls = []

        def start(self):
            self.calls.append(("start", eng.n))

        def stop(self):
            self.calls.append(("stop", eng.n))

    class Eng:
        n = 0

        def step(self):
            self.n += 1
    syncs = []
    eng, prof = Eng(), Prof()
    win = chip_smoke.profile_window(eng, prof, (30, 70),
                                    lambda: syncs.append(eng.n))
    for _ in range(115):
        eng.step()
    win["close"]()
    assert prof.calls == [("start", 30), ("stop", 70)]
    assert syncs == [30, 70] and win["iterations"] == 40
    assert win["wall_s"] >= 0
    eng, prof = Eng(), Prof()
    win = chip_smoke.profile_window(eng, prof, (30, 70), lambda: None)
    for _ in range(50):
        eng.step()
    assert prof.calls == [("start", 30)]
    win["close"]()
    win["close"]()
    assert prof.calls == [("start", 30), ("stop", 50)]
    assert win["iterations"] == 20
