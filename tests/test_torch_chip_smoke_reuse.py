"""chip_smoke.py's ``reuse`` phase on the CPU, at smoke size: the engine
phase's workload with host pools of 256 and 192 blocks on the reduced
qwen2-1.5b (the kernels' plain versions).  Copies are contaminated,
short copies are resumed and no block is restored past a valid prefix;
a planted whole-context restore (the swap-in before the repair) fails
the phase; the engine phase's 1024-block pool resumes no short copy.
One of the files ``tests/test_torch_chip_smoke_*.py``, split by
phase."""
import pytest

from chip_smoke_served import SIZES, served, served_held  # noqa: E402,F401
import chip_smoke  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import ServingEngine  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def bundle():
    cfg = get_smoke_config("qwen2-1.5b")
    return {"cfg": cfg, "params": T.init_params(cfg, seed=0, device="cpu")}


@pytest.fixture(scope="module")
def convs():
    return chip_smoke.conversations(8, (256, 288, 320, 352), (96, 128, 160),
                                    max_tokens=32)


@pytest.fixture(scope="module")
def reuse(bundle, convs):
    return chip_smoke.reuse_phase(bundle, convs, SIZES)


@pytest.mark.parametrize("cpu_blocks", chip_smoke.REUSE_CPU_BLOCKS)
def test_reuse_phase_resumes_short_copies(reuse, cpu_blocks):
    r = reuse[str(cpu_blocks)]
    assert r["contaminations"] > 0
    assert r["short_copy_swap_ins"] >= r["short_copy_resumes"] >= 1
    assert r["restores_past_valid_prefix"] == 0
    assert r["short_copy_recomputed_tokens"] > 0
    assert r["greedy_max_gap"] < chip_smoke.NEAR_TIE
    assert r["greedy_equal"] + r["greedy_near_ties"] == 8 * 2 * 32
    # the plain versions run on the CPU: no kernel launches to count
    assert set(r["launches"].values()) == {0}


def test_reuse_phase_catches_a_whole_context_restore(bundle, convs,
                                                     monkeypatch):
    """The swap-in before the repair (the whole context restored from a
    short copy, its stale blocks included) fails the phase."""
    monkeypatch.setattr(ServingEngine, "_resume_short_copy",
                        lambda self, rid, valid: self._swap_in_copy(rid))
    with pytest.raises(AssertionError, match="past the valid prefix"):
        chip_smoke.reuse_phase(bundle, convs, SIZES, cpu_blocks=(256,))


def test_engine_phase_pool_resumes_no_short_copy(served):
    _, _, eng, _ = served
    assert eng.reuse.stats()["short_copy_resumes"] == 0
    assert eng.reuse.stats()["contaminations"] == 0
