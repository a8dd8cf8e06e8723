"""chip_smoke.py's logic on the CPU, at smoke size: the train phase (5h)
and its FLOP count.

The script itself needs a GPU; here its train phase runs with
qwen2-1.5b's smoke config on CPU tensors, at small batch and decode
sizes.  One of the files ``tests/test_torch_chip_smoke_*.py``, split by
phase."""
import pytest

from chip_smoke_served import ROOT  # noqa: E402,F401
import chip_smoke  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def test_train_phase_on_the_cpu():
    """Every check of the phase on the CPU: the loss falls over 6 steps on
    one batch, remat on and off agree byte for byte, the CPU agrees with
    itself, every greedy token of the contiguous decode (bf16 cache) is
    the dense forward's argmax or a near-tie, the int8 cache's logits are
    finite, and the launcher's ``--device cpu`` run exits 0.  Device
    numbers (times, FLOP share, memory) are taken on CUDA only."""
    cfg = get_smoke_config("qwen2-1.5b")
    out = chip_smoke.train_phase("cpu", cfg=cfg, batch=(2, 16), steps=6,
                                 decode=(2, 12, 4, 24), cpu_check=(2, 16))
    assert out["arch"] == "qwen2-1.5b-smoke"
    losses = out["overfit_losses"]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert out["remat"]["byte_equal"] and out["remat"]["loss_equal"]
    assert out["device_vs_cpu"]["loss_rel"] == 0.0
    assert out["device_vs_cpu"]["max_grad_rel_l2"] == 0.0
    d = out["decode"]
    assert d["generated"] == 2 * 5 and d["equal"] + d["near_ties"] == 10
    assert d["max_gap"] < chip_smoke.NEAR_TIE
    assert d["int8"]["finite"]
    assert 0 <= d["int8"]["tokens_equal_bf16"] <= 10
    assert out["launcher"]["stdout"][0].startswith("arch=qwen2-1.5b-smoke")
    assert "step_ms" not in out and "memory" not in out


def test_train_phase_fails_a_loss_that_does_not_fall(monkeypatch):
    """A step that leaves the parameters as they were (lr 0) fails the
    overfit check."""
    from repro_torch.models import steps as S
    real = S.train_step
    monkeypatch.setattr(S, "train_step",
                        lambda *a, **kw: real(*a, **{**kw, "lr": 0.0}))
    with pytest.raises(AssertionError, match="did not fall"):
        chip_smoke.train_phase("cpu", cfg=get_smoke_config("qwen2-1.5b"),
                               batch=(2, 16), steps=3,
                               decode=(2, 12, 4, 24), cpu_check=(2, 16))


def test_train_flops_at_full_width():
    """qwen2-1.5b's step at B 8 x T 128: 6 FLOPs per matmul weight and
    token (1.31 B in the layers plus the 233 M head product) plus the
    attention term, and the CE product as computed over 512 positions."""
    cfg = get_config("qwen2-1.5b")
    f = chip_smoke.train_flops(cfg, 8, 128)
    layers = 28 * (1536 * 1536 + 2 * 1536 * 256 + 1536 * 1536
                   + 3 * 1536 * 8960)
    assert layers == 1_310_195_712
    head = 151936 * 1536
    assert f["model_flops"] == 6 * (layers + head) * 1024 \
        + 12 * 28 * 1536 * 128 * 1024
    assert f["ce_flops_as_computed"] == 6 * 8 * 512 * 1536 * 151936
    assert abs(f["ce_flops_as_computed"] / 1e12 - 5.74) < 0.01
