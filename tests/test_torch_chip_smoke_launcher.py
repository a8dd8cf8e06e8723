"""chip_smoke.py's logic on the CPU, at smoke size: the launcher phases
(5d, and 5e's subprocess) and the refusals without a GPU or outside a
checkout.

The script itself needs a GPU; here its phases run with the smoke
configs on CPU tensors (the kernels' plain versions), at the
conversation and pool sizes the script uses on the card.  One of the
files ``tests/test_torch_chip_smoke_*.py``, split by phase."""
import os
import shutil
import subprocess
import sys
import pytest

from chip_smoke_served import ROOT  # noqa: E402,F401
import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def test_refuses_without_gpu_and_outside_a_checkout(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    here = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert here.returncode != 0
    assert '"ok"' not in here.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, env=env,
                           timeout=120)
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout


def test_serve_phase_runs_the_launcher(tmp_path):
    """The serve phase's two launcher runs, on the CPU at the reduced
    width with two conversations: both policies report, the event log is
    well-formed, and no hand-written kernel launched (the plain versions
    run on the CPU)."""
    out = chip_smoke.serve_phase(tmp_path, device="cpu", conversations=2)
    pols = out["replay"]["policies"]
    assert set(pols) == {"vllm", "fastswitch"}
    assert all(p["total_tokens"] > 0 and p["callstack_wall_s"] > 0
               for p in pols.values())
    assert pols["fastswitch"]["kernel_launches"]["paged_attention"] == 0
    assert out["online_smoke"]["events"] > 0


def test_serve_phase_fails_on_a_failed_launcher_run(tmp_path):
    # ``--serve`` serves now: a policy the launcher does not know fails
    with pytest.raises(AssertionError, match="exited"):
        chip_smoke.run_launcher(["--policy", "no-such-policy"], tmp_path)


def test_serve_frontend_phase_boots_the_launcher():
    out = chip_smoke.serve_frontend_phase("cpu")
    assert out["tokens"] == 4 and out["finish"] == "length"
    assert out["stdout"][0].startswith("frontend: 2 real replica(s) on ")
    assert out["stdout"][-1] == "frontend: interrupted, shutting down"
