"""chip_smoke.py's logic on the CPU, at smoke size: the front-end (5e) and
prefix (5f) phases.

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


def test_frontend_phase_on_two_cpu_replicas(served, tmp_path):
    """The frontend phase at the reduced width on the CPU: nine turns, no
    affinity violation, two moved sessions with their KV byte-equal on
    arrival (the first to the other replica), both replicas swapping both
    ways, and every streamed token the dense argmax or a near-tie."""
    bundle = served[0]
    out = chip_smoke.frontend_phase(bundle, tmp_path)
    assert out["turns_finished"] == 9 and out["affinity_violations"] == 0
    assert out["events_validated"] == out["replicas"] == 2
    first, second = out["migrations"]
    assert first["moved"] and first["to"] == 1 - first["from"]
    assert first["valid_tokens"] > 0 and second["to"] == first["from"]
    assert second["moved"] == (second["from"] != second["to"])
    assert all(min(s.values()) > 0 for s in out["swap_ops_per_replica"])
    assert out["tokens"]["sessions"] == 8 and \
        out["tokens"]["generated"] > 60
    # the plain versions run on the CPU: nothing counted
    assert out["launches"] == {"paged_attention": 0, "block_gather_runs": 0,
                               "block_scatter_runs": 0}


def test_frontend_phase_catches_a_wrong_streamed_token(served):
    bundle = served[0]
    prompt = list(range(5, 25))
    good = chip_smoke.stream_checks(bundle, [[(prompt, [])]])
    assert good["generated"] == 0
    import torch
    from repro_torch.models import transformer as T
    toks = torch.tensor([prompt])
    logits, _, _ = T.forward_seq(bundle["params"], bundle["cfg"], toks)
    worst = int(logits[0, -1].argmin())
    with pytest.raises(AssertionError, match="below the dense maximum"):
        chip_smoke.stream_checks(bundle, [[(prompt, [worst])]])


def test_prefix_phase_against_the_cache_off(served, tmp_path):
    """The prefix phase on the CPU: the launcher's prefix smoke hits its
    shared system prompt, and every conversation finished in both runs
    has equal tokens (or a near-tie first difference)."""
    out = chip_smoke.prefix_phase(served[0], tmp_path, device="cpu")
    assert out["prefix_hits"] > 0 and out["prefix_tokens_saved"] > 0
    assert out["invariant_checks"] > 0 and out["events"] > 0
    assert out["conversations_compared"] > 0
    assert out["conversations_equal"] + len(out["near_ties"]) == \
        out["conversations_compared"]
