"""The engine phase of chip_smoke.py run once at smoke size on the CPU,
as module fixtures for the ``tests/test_torch_chip_smoke_*.py`` files
that read it (each importing module gets its own run).  Importing this
module also puts the checkout's root on ``sys.path``, so the test files
can import ``chip_smoke``."""
import os
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

SIZES = dict(gpu_blocks=160, cpu_blocks=1024, max_running=8)


@pytest.fixture(scope="module")
def served_held():
    """The engine phase at smoke size on the CPU, with the ``graphs``
    check over it: (bundle, convs, engine, swaps) and the checked
    buckets."""
    cfg = get_smoke_config("qwen2-1.5b")
    bundle = {"cfg": cfg, "params": T.init_params(cfg, seed=0,
                                                  device="cpu")}
    convs = chip_smoke.conversations(8, (256, 288, 320, 352),
                                     (96, 128, 160), max_tokens=32)
    with chip_smoke.replays_held_to_eager() as held:
        eng, wall, host, swaps = chip_smoke.run_engine(bundle, convs,
                                                       **SIZES)
    assert wall > 0 and set(host) == {"decode", "flush", "_scatter_rows",
                                      "prefill_chunk_compute",
                                      "copy_out_staged", "copy_in_staged"}
    return (bundle, convs, eng, swaps), held


@pytest.fixture(scope="module")
def served(served_held):
    return served_held[0]
