"""chip_smoke.py's logic on the CPU, at smoke size: the examples phase
(5l).

The script itself needs a GPU; here the phase runs ``examples/
torch_quickstart.py``'s engine with llama3.2-3b's reduced config on CPU
tensors (the kernels' plain versions, so no launch is counted), then the
quickstart and ``examples/torch_train_lm.py`` as subprocesses with
``--device cpu``.  One of the files ``tests/test_torch_chip_smoke_*.py``,
split by phase."""
import pytest

from chip_smoke_served import ROOT  # noqa: E402,F401
import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def test_examples_phase_on_the_cpu():
    """Every turn finished with preemption and swaps both ways, no copy
    retried or failed, greedy tokens within the near-tie rule, the
    decode step's graph counts, the host seconds by method; the
    quickstart's lines agree with the in-process engine; train_lm's loss
    falls and its checkpoint round-trips."""
    out = chip_smoke.examples_phase("cpu", train_steps=5)
    assert out["arch"] == "llama3.2-3b-smoke"
    assert out["tokens"] == 144 and out["turns"] == 12
    assert out["iterations"] == 144 and out["preemptions"] == 12
    assert out["swap_ops"] == 18
    assert out["swap_out_calls"] > 0 and out["swap_in_calls"] > 0
    assert out["copy_retries"] == out["copy_failures"] == 0
    assert out["greedy_equal"] + out["greedy_near_ties"] == 144
    assert out["greedy_max_gap"] < out["tolerance"] == chip_smoke.NEAR_TIE
    assert out["graphs_captured"] == out["eager_steps"] >= 1
    assert out["graph_replays"] + out["eager_steps"] == out["decode_steps"]
    # the plain versions run here: no kernel is launched
    assert out["launches"] == {"paged_attention": 0, "block_gather_runs": 0,
                               "block_scatter_runs": 0}
    assert set(out["host_s"]) == {"decode", "flush", "_scatter_rows",
                                  "prefill_chunk_compute",
                                  "copy_out_staged", "copy_in_staged"}
    assert out["quickstart_cli"] == {
        "wall_s": out["quickstart_cli"]["wall_s"], "tokens": 144,
        "iterations": 144, "preemptions": 12, "swap_ops": 18}
    t = out["train_lm_cli"]
    assert t["steps"] == 5 and t["loss_last"] < t["loss_first"]
    assert t["checkpoint_round_trip"]


def test_example_lines_are_read_or_the_phase_fails():
    lines = ["model: x", "served 144 tokens over 144 iters",
             "preemptions 12  swap ops 18  avg granularity 2.0 blocks/op"]
    assert chip_smoke._matched(chip_smoke.QUICKSTART_SERVED, lines,
                               "q")[1] == "144"
    assert chip_smoke._matched(chip_smoke.QUICKSTART_SWAPS, lines,
                               "q")[2] == "18"
    with pytest.raises(AssertionError, match="no line matching"):
        chip_smoke._matched(chip_smoke.TRAIN_LM_DONE, lines, "train_lm")
    done = "loss 6.241 -> 0.031; checkpoint round-trip OK (/x/ckpt.npz)"
    m = chip_smoke._matched(chip_smoke.TRAIN_LM_DONE, [done], "train_lm")
    assert (m[1], m[2]) == ("6.241", "0.031")
