"""chip_smoke.py's logic on the CPU, at smoke size: the engine phase (4),
its graphs check (5c) and the e2e phase (5).

The script itself needs a GPU; here its phases run with the smoke
configs on CPU tensors (the kernels' plain versions), at the
conversation and pool sizes the script uses on the card.  One of the
files ``tests/test_torch_chip_smoke_*.py``, split by phase."""
import pytest

from chip_smoke_served import SIZES, served, served_held  # noqa: E402,F401
import chip_smoke  # noqa: E402
from repro_torch.kernels import block_copy as bc  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def test_engine_phase_preempts_and_swaps_both_ways(served):
    _, convs, eng, swaps = served
    stats = chip_smoke.check_engine(eng, convs, swaps)
    assert stats["turns"] == 16
    assert stats["preemptions"] > 0
    assert stats["swap_out_calls"] > 0 and stats["swap_in_calls"] > 0
    assert all(o > 0 and i > 0
               for o, i in stats["swaps_out_in_by_conv"].values())
    assert stats["copy_retries"] == 0 and stats["swap_failure_resumes"] == 0


def test_engine_phase_catches_a_failed_swap_copy(served, monkeypatch):
    """A gather that raises once (as a failed launch would) is retried
    and the run still finishes every turn; check_engine must fail it."""
    bundle, convs, _, _ = served
    real = bc.block_gather_runs
    calls = []

    def fails_once(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("block_gather_runs: launch failed")
        return real(*a, **k)
    monkeypatch.setattr(bc, "block_gather_runs", fails_once)
    eng, _, _, swaps = chip_smoke.run_engine(bundle, convs, **SIZES)
    assert eng.done() and eng.swap.n_retries == 1
    with pytest.raises(AssertionError, match="copy_retries"):
        chip_smoke.check_engine(eng, convs, swaps)


def test_engine_phase_catches_a_conversation_never_swapped(served):
    _, convs, eng, swaps = served
    fewer = {k: v for k, v in swaps.items() if k != (3, "in")}
    with pytest.raises(AssertionError, match="not swapped both ways"):
        chip_smoke.check_engine(eng, convs, fewer)


@pytest.mark.parametrize("conv_id", range(8))
def test_e2e_phase_tokens_match_dense_forward(served, conv_id):
    bundle, convs, eng, _ = served
    res = chip_smoke.check_tokens(eng, bundle, convs[conv_id])
    assert res["generated"] == 64
    assert res["max_gap"] < res["tolerance"]


def test_e2e_phase_catches_a_wrong_token(served):
    bundle, convs, eng, _ = served
    hist = eng._token_hist_by_conv[0]
    first_gen = convs[0].turns[0].prompt_tokens
    saved = hist[first_gen]
    hist[first_gen] = (saved + 1) % bundle["cfg"].vocab_size
    try:
        with pytest.raises(AssertionError):
            chip_smoke.check_tokens(eng, bundle, convs[0], tol=1e-9)
    finally:
        hist[first_gen] = saved


def test_engine_phase_replays_one_step_variant_per_bucket(served_held):
    """Every decode step is a bucket's first (eager) step or a replay of
    its variant; one variant per bucket rebuild; and the first replay at
    each bucket was held against the eager step (``graphs`` phase)."""
    (_, convs, eng, swaps), held = served_held
    stats = chip_smoke.check_engine(eng, convs, swaps)
    assert stats["eager_steps"] + stats["graph_replays"] == \
        stats["decode_steps"]
    assert stats["graphs_captured"] == eng.runner.stats.rebuilds >= 1
    assert stats["batch_bucket"] == 8
    assert 1 <= len(held) <= stats["graphs_captured"]
    assert held[-1]["bucket"][0] == 8
    assert all(all(c["byte_equal"].values()) for c in held)


def test_engine_phase_catches_a_miscounted_step(served, monkeypatch):
    _, convs, eng, swaps = served
    monkeypatch.setattr(eng.runner.stats, "graph_replays",
                        eng.runner.stats.graph_replays - 1)
    with pytest.raises(AssertionError, match="replayed"):
        chip_smoke.check_engine(eng, convs, swaps)


def test_first_divergence_names_the_position_and_gap(served):
    bundle = served[0]
    a = list(range(5, 25))
    assert chip_smoke.first_divergence(bundle, a, a + [1]) is None
    pos, gap = chip_smoke.first_divergence(bundle, a + [7], a + [8])
    assert pos == len(a) and gap >= 0.0
