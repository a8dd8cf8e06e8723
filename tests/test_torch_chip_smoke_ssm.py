"""chip_smoke.py's logic on the CPU, at smoke size: the ssm phase (5i),
its FLOP count and its decode-step bound.

The script itself needs a GPU; here its ssm phase runs with zamba2-7b's
and rwkv6-1.6b's smoke configs on CPU tensors, at small batch and decode
sizes.  On CPU tensors the Mamba2 blocks run ``gla_chunked``, so the
scan kernel is launched no time (on the card: once per Mamba2 layer of a
prefill), and the kernel-against-plain prefill compares two identical
runs.  One of the files ``tests/test_torch_chip_smoke_*.py``, split by
phase."""
import contextlib

import pytest
import torch

from chip_smoke_served import ROOT  # noqa: E402,F401
import chip_smoke  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def phase():
    return chip_smoke.ssm_phase(
        "cpu", zcfg=get_smoke_config("zamba2-7b"),
        rcfg=get_smoke_config("rwkv6-1.6b"), serve=((2, 12), 4, 24),
        cut_batch=(2, 16),
        train=dict(batch=(2, 16), steps=6, decode=(2, 12, 4, 24),
                   cpu_check=(2, 16)))


def test_zamba2_serving_on_the_cpu(phase):
    """The prefill (no kernel launch on CPU tensors), the plain scan's
    prefill (the same run here), the first layer's scan, and every greedy
    token of 4 decode steps the dense forward's argmax or a near-tie.
    Device numbers are taken on CUDA only."""
    z = phase["zamba2"]
    assert z["arch"] == "zamba2-7b-smoke" and z["mamba2_layers"] == 2
    assert z["prefill"] == {"batch": [2, 12], "scan_launches": 0}
    kv = z["kernel_vs_plain"]
    assert kv["last_logits_max_abs"] == 0.0
    assert kv["first_layer_scan"] == {"y": 0.0, "S": 0.0}
    d = z["decode"]
    assert d["generated"] == 2 * 5 and d["equal"] + d["near_ties"] == 10
    assert d["max_gap"] < chip_smoke.NEAR_TIE
    assert "step_ms" not in d and "peak_memory_gb" not in z


def test_zamba2_cut_train_step_on_the_cpu(phase):
    """One period (2 layers of the smoke config) against the CPU: the
    same numbers, and no scan launched."""
    t = phase["zamba2_train"]
    assert t["layers"] == 2 and t["scan_launches"] == 0
    assert t["loss_rel"] == 0.0 and t["max_grad_rel_l2"] == 0.0
    assert any("mamba_p" in k for k in t["grad_rel_l2"])
    assert any("attn_shared" in k for k in t["grad_rel_l2"])


def test_rwkv6_training_on_the_cpu(phase):
    """``train_phase`` on rwkv6's smoke config: the loss falls, remat
    changes no byte, the decode's tokens are the dense argmax or
    near-ties, no int8 decode (no attention cache), the launcher runs."""
    r = phase["rwkv6"]
    assert r["arch"] == "rwkv6-1.6b-smoke"
    losses = r["overfit_losses"]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert r["remat"]["byte_equal"]
    assert r["device_vs_cpu"]["loss_rel"] == 0.0
    d = r["decode"]
    assert d["generated"] == 10 and "int8" not in d
    assert r["launcher"]["stdout"][0].startswith("arch=rwkv6-1.6b-smoke")


def test_launcher_refusals_on_the_cpu(phase):
    """Both launchers exit non-zero on zamba2-7b with their messages:
    here the trainer for want of a GPU (on the card: for the training
    state's size, tests/test_torch_ssm_train.py fakes the card), the
    server with the reference's message."""
    r = phase["refusals"]
    assert r["train"]["exit"] != 0
    assert "torch.cuda.is_available() is false" in r["train"]["message"]
    assert r["serve"]["exit"] != 0
    assert r["serve"]["message"] == (
        "zamba2-7b: real-mode serving needs a uniform GQA arch (paged pool "
        "path); use sim mode for this family")


def test_ssm_phase_fails_a_wrong_scan(monkeypatch):
    """A scan whose y is 5 % off in the comparison prefill fails the
    kernel-against-plain checks (at smoke size the first layer's scan
    bound is the one that catches it).  On the CPU the blocks run
    ``gla_chunked``, so here they are routed to the kernel's route (whose
    CPU twin is the plain version), and the comparison's scan is made
    wrong."""
    from repro_torch.kernels import ops
    from repro_torch.models import mamba2
    monkeypatch.setattr(mamba2, "ssd_scan",
                        lambda q, k, v, logw, cfg, state:
                        mamba2.ssd_scan_kernel(q, k, v, logw,
                                               cfg.ssm.chunk_size))

    @contextlib.contextmanager
    def wrong_scan():
        real = ops.gla_scan_scalar

        def off(q, k, v, logw, *, chunk=64):
            y, s = real(q, k, v, logw, chunk=chunk)
            return y * 1.05, s
        ops.gla_scan_scalar = off
        try:
            yield
        finally:
            ops.gla_scan_scalar = real
    monkeypatch.setattr(chip_smoke, "plain_scan", wrong_scan)
    with pytest.raises(AssertionError,
                       match="plain version|gla_scan_scalar: y"):
        chip_smoke.zamba2_serve("cpu", get_smoke_config("zamba2-7b"),
                                prompts=(2, 12), n_steps=1, cache_len=16)


def test_ssm_flops_and_bounds_at_full_width():
    """rwkv6-1.6b's step at B 8 x T 128: 6 FLOPs per matmul weight and
    token (24 layers of 6 d^2 + 12 r d + 2 d d_ff, the head), no
    attention term; zamba2-7b's counts the shared block once per period;
    a zamba2 decode step's bytes."""
    r = get_config("rwkv6-1.6b")
    d, R = 2048, 64
    layers = 24 * (6 * d * d + 12 * R * d + 2 * d * 7168)
    assert chip_smoke.matmul_weights(r) == (layers + 65536 * d, 0)
    f = chip_smoke.train_flops(r, 8, 128)
    assert f["model_flops"] == 6 * (layers + 65536 * d) * 1024
    z = get_config("zamba2-7b")
    w, n_attn = chip_smoke.matmul_weights(z)
    assert n_attn == 13
    shared = 4 * 3584 * 3584 + 3 * 3584 * 14336
    mamba = 3584 * (2 * 7168 + 2 * 64 + 112) + 7168 * 3584
    assert w == 68 * mamba + 13 * shared + 32000 * 3584
    # a step's bytes: the parameters but the embedding table, the caches
    # read and written (the smoke config's serving copy)
    cfg = get_smoke_config("zamba2-7b")
    params = T.serving_params(T.init_params(cfg, seed=0, device="cpu"))
    caches = T.init_caches(cfg, 2, 24, device="cpu")
    weights = sum(t.numel() * t.element_size()
                  for k, sub in params.items() if k != "embed"
                  for t in chip_smoke._leaves(sub))
    cache = sum(t.numel() * t.element_size() for t in caches)
    assert chip_smoke.decode_step_bytes(params, caches) == \
        weights + 2 * cache
    assert params["mamba_p"]["mamba"]["w_in"].dtype == torch.bfloat16


def test_device_vs_cpu_fails_a_wrong_gradient(monkeypatch):
    """The card-against-CPU check fails a device run whose gradient leaf
    is 50 % off, though the conditioning raises the bound of
    ill-conditioned leaves (here the device run is the third
    ``loss_and_grads`` call, after the CPU's and its perturbed twin's)."""
    from repro_torch.models import steps as S
    real, calls = S.loss_and_grads, []

    def wrong_third(params, cfg, data, remat=True):
        loss, grads = real(params, cfg, data, remat=remat)
        calls.append(1)
        if len(calls) == 3:
            grads["final_norm"]["scale"] = grads["final_norm"]["scale"] * 1.5
        return loss, grads
    monkeypatch.setattr(S, "loss_and_grads", wrong_third)
    with pytest.raises(AssertionError, match="final_norm/scale"):
        chip_smoke.device_vs_cpu(get_smoke_config("rwkv6-1.6b"), "cpu",
                                 (2, 16), chip_smoke.TRAIN_GRAD_RTOL)
