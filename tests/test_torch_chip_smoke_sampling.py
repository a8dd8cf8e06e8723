"""chip_smoke.py's logic on the CPU, at smoke size: the sampling phase
(5b).

The script itself needs a GPU; here its phases run with the smoke
configs on CPU tensors (the kernels' plain versions), at the
conversation and pool sizes the script uses on the card.  One of the
files ``tests/test_torch_chip_smoke_*.py``, split by phase."""
import pytest
import torch

from chip_smoke_served import served, served_held  # noqa: E402,F401
import chip_smoke  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def sampled_held(served):
    """The sampling phase's first run, with the ``graphs`` check over it:
    (engine, requests, checked variants)."""
    bundle = served[0]
    with chip_smoke.replays_held_to_eager() as held:
        eng, convs = chip_smoke.run_sampling(bundle)
    return eng, convs, held


def test_sampling_phase_serves_both_variants(served, sampled_held):
    bundle = served[0]
    eng, convs, held = sampled_held
    stats = chip_smoke.check_sampling(eng, convs)
    assert stats["sampled_graphs"] >= 1 and stats["buckets"] >= 1
    assert any(c["sampled"] for c in held)
    assert all(all(c["byte_equal"].values()) for c in held)
    for c in convs:
        if c.conv_id % 2:
            r = chip_smoke.check_sampled_tokens(eng, bundle, c,
                                                chip_smoke.SAMPLING)
            assert r["equal"] + len(r["near_ties"]) == r["generated"] == 32
        else:
            r = chip_smoke.check_tokens(eng, bundle, c)
            assert r["max_gap"] < r["tolerance"]
    again, _ = chip_smoke.run_sampling(bundle)
    assert again._token_hist_by_conv == eng._token_hist_by_conv
    plain, _ = chip_smoke.run_sampling(bundle, sampling=None)
    assert plain.runner.stats.sampled_graphs == 0
    for c in convs:
        same = plain._token_hist_by_conv[c.conv_id] == \
            eng._token_hist_by_conv[c.conv_id]
        assert same == (c.conv_id % 2 == 0)
    assert chip_smoke.threefry_on_card_equals_cpu("cpu", vocab=1024) \
        == 8 * 1024


def test_sampling_phase_catches_a_wrong_sampled_token(served,
                                                      sampled_held):
    """The least likely token in place of a drawn one is no near-tie."""
    import torch as th
    from repro_torch.models import transformer as T
    bundle = served[0]
    eng, convs, _ = sampled_held
    conv = convs[1]
    hist = eng._token_hist_by_conv[1]
    i = conv.turns[0].prompt_tokens + 5
    with th.no_grad():
        logits, _, _ = T.forward_seq(bundle["params"], bundle["cfg"],
                                     th.tensor([hist[:i]]))
    saved = hist[i]
    hist[i] = int(logits[0, -1].argmin())
    try:
        with pytest.raises(AssertionError, match="no near-tie"):
            chip_smoke.check_sampled_tokens(eng, bundle, conv,
                                            chip_smoke.SAMPLING, tol=1e-9)
    finally:
        hist[i] = saved
