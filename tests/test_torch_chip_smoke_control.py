"""chip_smoke.py's ``control`` phase on the CPU, at smoke size: the engine
phase's workload and pool under the chaos plan, the containment cases,
an abort in each lifecycle state and a stop token, with the reduced
qwen2-1.5b (the kernels' plain versions).  Then the phase's checks
against a planted leak and a planted wrong survivor token: each must
fail.  One of the files ``tests/test_torch_chip_smoke_*.py``, split by
phase."""
import pytest

from chip_smoke_served import SIZES  # noqa: E402
import chip_smoke  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import ServingEngine  # noqa: E402
from repro_torch.core.decode_runner import DecodeRunner  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

STATES = ("waiting", "mid_chunked_prefill", "running", "swapped",
          "swapping_in", "recompute_waiting", "finished_retained")


@pytest.fixture(scope="module")
def bundle():
    cfg = get_smoke_config("qwen2-1.5b")
    return {"cfg": cfg, "params": T.init_params(cfg, seed=0, device="cpu")}


@pytest.fixture(scope="module")
def convs():
    return chip_smoke.conversations(8, (256, 288, 320, 352), (96, 128, 160),
                                    max_tokens=32)


@pytest.fixture(scope="module")
def control(bundle, convs, tmp_path_factory):
    return chip_smoke.control_phase(bundle, convs, SIZES,
                                    tmp_path_factory.mktemp("control"))


def test_control_phase_chaos(control):
    ch = control["chaos"]
    assert len(ch["fault_kinds"]) >= 3
    assert ch["invariant_checks"] > 0 and ch["events"] > 0
    assert set(ch["turns_by_finish"]) <= set(chip_smoke.CONTROL_FINISHES)
    assert sum(ch["turns_by_finish"].values()) >= 8
    assert ch["tokens_checked"] > 0
    assert ch["tokens_equal"] + ch["near_ties"] == ch["tokens_checked"]
    assert ch["max_gap"] < chip_smoke.NEAR_TIE


def test_control_phase_containment_and_stop(control):
    c = control["containment"]
    assert c["poison"]["generated"] == chip_smoke.CONTROL_TOKENS
    assert c["permanent_swap_out"]["recompute_resumes"] >= 1
    st = control["stop"]
    assert st["tokens"] == st["stop_at"] + 1 < 32 and st["stop_at"] > 0
    assert c["stalled_swap"]["watchdog_rescues"] >= 1


def test_control_phase_aborts_every_state(control):
    by = control["aborts"]["by_state"]
    assert tuple(by) == STATES
    for state in STATES:
        assert by[state]["survivor"]["generated"] == \
            chip_smoke.CONTROL_TOKENS
    # the states that hold a decode row when aborted
    assert by["running"]["had_row"] and by["swapping_in"]["had_row"]
    assert by["swapping_in"]["successor"]["generated"] == 6
    # the plain versions run on the CPU: no kernel launches to count
    assert set(control["launches"].values()) == {0}
    assert control["seconds"] > 0


@pytest.mark.parametrize("plant", ["row_left_mapped", "blocks_leaked"])
def test_control_phase_catches_a_leak(bundle, monkeypatch, plant):
    """An abort that leaves the freed row on its blocks, or one that
    leaves a block allocated: the abort matrix fails."""
    if plant == "row_left_mapped":
        monkeypatch.setattr(DecodeRunner, "release",
                            lambda self, rid: self._prefills.pop(rid, None))
        match = "D2|runner state|freed row|runner rows"
    else:
        real = ServingEngine.abort

        def leaky(self, handle, reason="abort"):
            done = real(self, handle, reason)
            self.gpu_mgr.allocate_tokens(handle, 16)
            self.gpu_mgr.note_tokens(handle, 16)
            return done
        monkeypatch.setattr(ServingEngine, "abort", leaky)
        match = "B2|leaked"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.control_aborts(bundle, SIZES)


def _wrong_last_token(monkeypatch, planted_in):
    """After each drain of an engine ``planted_in`` picks, the last token
    of every history in it is replaced by the next id."""
    real = chip_smoke.drain_engine

    def drain(eng, max_iters=4000):
        outs = real(eng, max_iters)
        if planted_in(eng):
            vocab = eng.model_bundle["cfg"].vocab_size
            for hist in eng._token_hist_by_conv.values():
                hist[-1] = (hist[-1] + 1) % vocab
        return outs
    monkeypatch.setattr(chip_smoke, "drain_engine", drain)


def test_control_phase_catches_a_wrong_survivor_token(bundle, monkeypatch):
    """A survivor whose last token is not the fault-free run's (nor a
    near-tie of it): the containment and the abort checks each fail."""
    _wrong_last_token(monkeypatch,
                      lambda eng: eng.config.fault_plan is not None)
    with pytest.raises(AssertionError, match="poison survivor"):
        chip_smoke.control_containment(bundle, SIZES)
    _wrong_last_token(monkeypatch, lambda eng: eng.metrics.aborted > 0)
    with pytest.raises(AssertionError, match="survivor of an abort"):
        chip_smoke.control_aborts(bundle, SIZES)
