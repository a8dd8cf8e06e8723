"""The port's dev scripts, ``scripts/torch_dev_{engine,kernels,smoke}.py``,
on the CPU with ``--device cpu`` at small inputs, with ``jax`` and
``repro`` made unimportable: each exits 0 and prints its lines; without
``--device cpu`` each refuses to run where there is no CUDA device.
Then chip_smoke's ``dev`` phase, which reads their lines, at the same
small inputs."""
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

# run a script as __main__ with jax and the reference unimportable
BLOCKED = ("import runpy, sys\n"
           "sys.modules['jax'] = None\n"
           "sys.modules['repro'] = None\n"
           "sys.argv = sys.argv[1:]\n"
           "runpy.run_path(sys.argv[0], run_name='__main__')\n")


def _run(script, *args):
    return subprocess.run(
        [sys.executable, "-c", BLOCKED, str(chip_smoke.SCRIPTS / script),
         *args], capture_output=True, text=True, timeout=600,
        cwd=chip_smoke.ROOT)


def test_dev_kernels_on_the_cpu():
    run = _run("torch_dev_kernels.py", "--device", "cpu")
    assert run.returncode == 0, run.stderr
    assert run.stdout.splitlines() == [
        f"{k} maxerr 0.0"
        for k in ("paged_attention", "block_copy", "block_copy_grouped")]


def test_dev_kernels_runs_the_reference_case():
    """torch_dev_kernels.py's paged attention is scripts/dev_kernels.py's
    own case: its batch, heads, head_dim 64, pages and pool, in fp32."""
    import re
    ref = (chip_smoke.SCRIPTS / "dev_kernels.py").read_text()
    port = (chip_smoke.SCRIPTS / "torch_dev_kernels.py").read_text()
    shape = re.compile(r"^B, Hq, Hkv, D, bs, nb, npages = (.*)$", re.M)
    assert shape.search(port)[1] == shape.search(ref)[1] == \
        "3, 8, 2, 64, 16, 32, 4"
    assert "q = jax.random.normal(ks[0], (B, Hq, D), jnp.float32)" in ref
    assert re.search(r'^DTYPE = "float32"$', port, re.M)
    assert "not covered" not in port


def test_dev_engine_on_the_cpu():
    run = _run("torch_dev_engine.py", "4", "--device", "cpu")
    assert run.returncode == 0, run.stderr
    lines = run.stdout.splitlines()
    assert lines[0].startswith("trace: {'n': 4")
    rows = [chip_smoke.DEV_ENGINE.match(ln) for ln in lines[1:]]
    assert [m[1] for m in rows] == ["vllm", "+dbg", "+dbg+reuse",
                                    "fastswitch"]
    assert len({m[3] for m in rows}) == 1


def test_dev_smoke_on_the_cpu():
    run = _run("torch_dev_smoke.py", "qwen2-1.5b", "rwkv6-1.6b",
               "--device", "cpu")
    assert run.returncode == 0, run.stderr
    assert [ln.split()[:2] for ln in run.stdout.splitlines()] == [
        ["OK", "qwen2-1.5b"], ["OK", "rwkv6-1.6b"]]


@pytest.mark.parametrize("script", ["torch_dev_kernels.py",
                                    "torch_dev_engine.py",
                                    "torch_dev_smoke.py"])
def test_dev_scripts_refuse_without_cuda(script):
    """No ``--device``: the card, which this machine lacks."""
    run = _run(script)
    assert run.returncode != 0
    assert "no CUDA device" in run.stderr


def test_dev_phase_on_the_cpu():
    out = chip_smoke.dev_phase("cpu", conversations=4,
                               archs=("qwen2-1.5b",))
    assert out["kernels"]["max_abs_err"] == {
        "paged_attention": 0.0, "block_copy": 0.0, "block_copy_grouped": 0.0}
    assert out["kernels"]["launches"] is None
    assert list(out["engine"]["policies"]) == ["vllm", "+dbg", "+dbg+reuse",
                                               "fastswitch"]
    assert out["smoke"]["archs"] == ["qwen2-1.5b"]
