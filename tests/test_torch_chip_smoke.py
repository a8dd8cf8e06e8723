"""chip_smoke.py's logic on the CPU, at smoke size.

The script itself needs a GPU; here its engine and end-to-end phases run
with the qwen2-1.5b smoke config on CPU tensors (the kernels' plain
versions), at the conversation and pool sizes the script uses on the
card, and the script is shown to refuse to run without a GPU or outside
a checkout."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import block_copy as bc  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

SIZES = dict(gpu_blocks=160, cpu_blocks=1024, max_running=8)


@pytest.fixture(scope="module")
def served():
    cfg = get_smoke_config("qwen2-1.5b")
    bundle = {"cfg": cfg, "params": T.init_params(cfg, seed=0,
                                                  device="cpu")}
    convs = chip_smoke.conversations(8, (256, 288, 320, 352),
                                     (96, 128, 160), max_tokens=32)
    eng, wall, host, swaps = chip_smoke.run_engine(bundle, convs, **SIZES)
    assert wall > 0 and set(host) == {"decode", "prefill_chunk_compute",
                                      "copy_out_staged", "copy_in_staged"}
    return bundle, convs, eng, swaps


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


def test_attention_tolerance_passes_one_ulp_and_fails_a_dropped_tile():
    """The kernel check's per-element bound at the script's largest case
    (B 32, contexts up to 2048): one bf16 ulp everywhere passes, the
    longest row walking one 64-token tile fewer fails."""
    case = chip_smoke.attention_case(32, 128, torch.device("cpu"), seed=160)
    args = [case["q"], case["k"], case["v"], case["bt"], case["ctx"],
            case["scale"], case["ppcb"]]
    ref = pa.paged_attention_plain(*args)
    assert chip_smoke.attention_error(ref, ref) == 0.0
    up = (ref.float() * (1 + 2 ** -8)).bfloat16()
    assert chip_smoke.attention_error(up, ref) > 0
    args[4] = case["ctx"].clone()
    args[4][-2] -= 64
    short = pa.paged_attention_plain(*args)
    with pytest.raises(AssertionError, match="max abs error"):
        chip_smoke.attention_error(short, ref)


def test_busy_seconds_merges_overlapping_intervals():
    assert chip_smoke.busy_seconds([(0, 2e6), (1e6, 3e6), (5e6, 6e6),
                                    (5.5e6, 5.6e6)]) == 4.0


def test_bounds_follow_the_published_peaks():
    ms, by = chip_smoke.bound_ms(3.35e9, 1.0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = chip_smoke.bound_ms(1.0, 989e9)
    assert by == "operations" and ms == pytest.approx(1.0)


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
