"""chip_smoke.py's ``dryrun`` phase rehearsed on the CPU: its checks of the
dry-run's printed cases, of argument bytes against the real step's
tensors and of the roofline floor against a measured step, and the (1,
1) cross-check itself at the reduced qwen2-1.5b config (the CLI in a
subprocess, the real steps on the CPU)."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

OUT = """OK   qwen2-1.5b x train_4k x 16x16                                  args=  0.29GiB temp= 12.00GiB dom=memory     lower=1.0s compile=9.8s
SKIP qwen2-1.5b x long_500k x 16x16                                 skip: pure full-attention arch without a windowed/recurrent variant (DESIGN.md long_500k rule)
OK   zamba2-7b x long_500k x 16x16                                  args=  0.10GiB temp=  0.15GiB dom=collective lower=0.0s compile=3.3s
"""


def test_dryrun_output_checked():
    """Counts of a clean run; a FAIL line, a non-zero exit, a skip by
    another rule and an empty run each fail the phase."""
    c = cs.check_dryrun_all(OUT, 0)
    assert (c["ok"], c["skipped"], c["failed"]) == (2, 1, 0)
    fail = OUT + ("FAIL gemma3-12b x prefill_32k x 16x16"
                  + " " * 32 + "RuntimeError: boom\n")
    with pytest.raises(AssertionError, match="1 failed"):
        cs.check_dryrun_all(fail, 1)
    with pytest.raises(AssertionError, match="exited 1"):
        cs.check_dryrun_all(OUT, 1)
    with pytest.raises(AssertionError, match="another rule"):
        cs.check_dryrun_all(OUT + "SKIP x x y  no paged pool\n", 0)
    with pytest.raises(AssertionError, match="no case"):
        cs.check_dryrun_all("", 0)


def test_argument_bytes_and_floor_checks():
    """The byte check passes on the tensors it counts and fails with one
    leaf missing; the floor check fails a floor above the step."""
    ts = [torch.zeros(3, 5), torch.zeros(7, dtype=torch.int32),
          torch.zeros((), dtype=torch.int32)]
    n = 3 * 5 * 4 + 7 * 4 + 4
    assert cs.check_argument_bytes(n, ts) == n
    with pytest.raises(AssertionError, match="real step holds"):
        cs.check_argument_bytes(n, ts[:-1])
    rf = {"t_compute_s": 0.010, "t_memory_s": 0.130}
    assert cs.check_floor(rf, 0.40) == 0.130
    with pytest.raises(AssertionError, match="exceeds the measured"):
        cs.check_floor(rf, 0.12)


def test_cross_check_at_smoke_size(tmp_path):
    """The (1, 1) cross-check end to end at the reduced config: the CLI's
    argument bytes equal the real train and decode steps' tensors."""
    r = cs.dryrun_cross_check(torch.device("cpu"), tmp_path, smoke=True,
                              batch=2, seq=32, steps=1)
    for kind in ("train", "decode"):
        row = r[kind]
        assert row["argument_bytes_equal"] and row["argument_bytes"] > 0
        assert 0 < row["floor_ms"] <= row["step_ms"]
        assert row["max_memory_allocated"] is None


def test_watch_exit_times_the_process_where_it_ends():
    """``watch_exit`` notes a background process's end when it comes, not
    when the caller next looks, and drains its output meanwhile."""
    import subprocess
    import time
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, time; sys.stdout.write('x' * 200000); "
         "sys.stdout.flush(); time.sleep(0.5)"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    done = cs.watch_exit(proc, t0)
    time.sleep(2.5)
    done["thread"].join(timeout=30)
    assert not done["thread"].is_alive() and proc.returncode == 0
    assert len(done["stdout"]) == 200000 and done["stderr"] == ""
    assert 0.5 <= done["seconds"] < 2.0
