"""chip_smoke.py's logic on the CPU, at smoke size: the families phase
(5j) for gemma3-12b, deepseek-v2-236b and whisper-large-v3.

The script itself needs a GPU; here its families phase runs with the
three smoke configs on CPU tensors, at small batch and decode sizes:
gemma3 from a prompt past its window of 64 (the rings rolled) and from
one inside it, deepseek with its 2 layers, whisper through
``train_phase``.  A ring rolled off by one slot, and an MLA absorption
that mixes up heads, each make the phase fail.  One of the files
``tests/test_torch_chip_smoke_*.py``, split by phase."""
import pytest
import torch

from chip_smoke_served import ROOT  # noqa: E402,F401
import chip_smoke  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import steps as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

GEMMA = (((2, 70), (1, 20)), 6)
DEEPSEEK = ((2, 12), 4)


@pytest.fixture(scope="module")
def phase():
    return chip_smoke.families_phase(
        "cpu", gcfg=get_smoke_config("gemma3-12b"),
        dcfg=get_smoke_config("deepseek-v2-236b"),
        wcfg=get_smoke_config("whisper-large-v3"), gemma=GEMMA,
        gemma_train=(2, 16), deepseek=DEEPSEEK, check=(2, 16),
        whisper=dict(batch=(2, 16), steps=6, decode=(2, 12, 4, 24),
                     cpu_check=(2, 16)))


def test_gemma3_serving_on_the_cpu(phase):
    """Both prefills: the rings hold the prefill's K byte for byte (the
    first prompt rolled by (70 - 64) % 64 = 6) and the history's after
    the decode; every token the dense argmax or a near-tie.  Device
    numbers are taken on CUDA only."""
    g = phase["gemma3"]
    assert g["arch"] == "gemma3-12b-smoke" and g["window"] == 64
    first, second = g["runs"]
    assert first["batch"] == [2, 70] and first["ring_shift"] == 6
    assert first["ring_slots"] == 64 and second["ring_slots"] == 26
    assert second["ring_shift"] is None
    assert first["decode_slots"] == [6, 11]
    assert first["decode_overwrites"] == 6
    assert second["decode_overwrites"] == 0
    for run in g["runs"]:
        assert run["ring_after_prefill"]["max_abs"] == 0.0
        after = run["ring_after_decode"]
        assert after["max_rel_l2"] < chip_smoke.RING_REL_L2
        assert after["off_by_one_min_rel_l2"] > 1.0
        d = run["decode"]
        n = run["batch"][0] * (run["steps"] + 1)
        assert d["generated"] == n and d["equal"] + d["near_ties"] == n
        assert d["max_gap"] < d["tolerance"]
        assert "step_ms" not in run
    assert "peak_memory_gb" not in g


def test_gemma3_training_on_the_cpu(phase):
    t = phase["gemma3_train"]
    assert t["layers"] == 2 and len(t["losses"]) == 8
    assert t["losses"][-1] < t["losses"][0]
    c = phase["gemma3_vs_cpu"]
    assert c["loss_rel"] == 0.0 and c["max_grad_rel_l2"] == 0.0
    assert any("periods" in k for k in c["grad_rel_l2"])


def test_deepseek_serving_on_the_cpu(phase):
    """Layer 0's absorbed decode within its bound of the sequence
    forward; every token equal, a logit or routing near-tie, or the
    prefill's token after a capacity drop, and no decode step dropping
    a pair."""
    d = phase["deepseek"]
    assert d["arch"] == "deepseek-v2-236b-smoke" and d["layers"] == 2
    assert d["experts"] == [4, 2, 1]
    l0 = d["layer0"]
    assert l0["positions"] == 4
    assert 0 < l0["max_rel_l2"] < chip_smoke.MLA_LAYER_RTOL
    dec = d["decode"]
    assert dec["generated"] == 2 * 5 == sum(
        dec[k] for k in ("equal", "logit_near_tie", "routing_near_tie",
                         "prefill_capacity_drop"))
    assert dec["decode_pairs_dropped"] == 0
    c = phase["deepseek_vs_cpu"]
    assert c["loss_rel"] == 0.0
    assert any("layer0" in k for k in c["grad_rel_l2"])


def test_whisper_training_on_the_cpu(phase):
    """``train_phase`` on whisper's smoke config with encoder frames: the
    loss falls, remat changes no byte, the decode's tokens (bf16 and
    int8 self caches) are the dense argmax or near-ties, the card against
    the CPU at 2 + 2 layers, the launcher runs."""
    w = phase["whisper"]
    assert w["arch"] == "whisper-large-v3-smoke"
    assert w["overfit_losses"][-1] < w["overfit_losses"][0]
    assert w["remat"]["byte_equal"]
    assert w["device_vs_cpu"]["loss_rel"] == 0.0
    assert any("enc_layers" in k for k in w["device_vs_cpu"]["grad_rel_l2"])
    d = w["decode"]
    assert d["generated"] == 2 * 5 and d["int8"]["finite"]
    assert w["launcher"]["stdout"][0].startswith(
        "arch=whisper-large-v3-smoke")


def test_refusals_on_the_cpu(phase):
    """The trainer refuses gemma3-12b and deepseek-v2-236b (here for want
    of a GPU; on the card for their states' size,
    tests/test_torch_families_train.py fakes the card); the server
    refuses all three with the reference's message."""
    r = phase["refusals"]
    assert set(r) == {"train:gemma3-12b", "serve:gemma3-12b",
                      "train:deepseek-v2-236b", "serve:deepseek-v2-236b",
                      "serve:whisper-large-v3"}
    for key, rec in r.items():
        assert rec["exit"] != 0
        if key.startswith("serve:"):
            arch = key.split(":")[1]
            assert rec["message"] == (
                f"{arch}: real-mode serving needs a uniform GQA arch (paged "
                "pool path); use sim mode for this family")
        else:
            assert "torch.cuda.is_available() is false" in rec["message"]


def test_a_wrong_ring_roll_fails(monkeypatch):
    """Rings rolled one slot too far after ``caches_from_prefill`` fail
    the ring check."""
    real = S.caches_from_prefill

    def off_by_one(cfg, raw, batch, cache_len):
        c = real(cfg, raw, batch, cache_len)
        return c._replace(local_k=torch.roll(c.local_k, 1, 3),
                          local_v=torch.roll(c.local_v, 1, 3))
    monkeypatch.setattr(S, "caches_from_prefill", off_by_one)
    with pytest.raises(AssertionError, match="ring slot"):
        chip_smoke.gemma3_serve("cpu", get_smoke_config("gemma3-12b"),
                                ((1, 70),), 2)


def test_a_wrong_mla_absorption_fails(monkeypatch):
    """An absorbed decode whose w_uk heads are shifted by one (a reshape
    that mixes up heads) fails layer 0's check."""
    real = attn.mla_decode

    def mixed(p, x, cfg, cache, pos):
        m = cfg.mla
        w = p["w_uk"].reshape(m.kv_lora_rank, cfg.n_heads,
                              m.nope_head_dim).roll(1, 1)
        return real(dict(p, w_uk=w.reshape(p["w_uk"].shape)), x, cfg,
                    cache, pos)
    monkeypatch.setattr(attn, "mla_decode", mixed)
    with pytest.raises(AssertionError, match="absorbed decode"):
        chip_smoke.deepseek_serve("cpu", get_smoke_config("deepseek-v2-236b"),
                                  (2, 12), 2)


def test_whisper_flops_at_full_width():
    """whisper-large-v3's step at B 8 x T 128: 6 FLOPs per weight and
    frame through the encoder (and each decoder layer's cross K/V
    projections), per weight and token through the decoder and the
    head, and the attention terms."""
    c = get_config("whisper-large-v3")
    d, f, S_enc, V = 1280, 5120, 1500, 51866
    frames, tokens = 8 * S_enc, 8 * 128
    want = (6 * frames * (32 * (4 * d * d + 2 * d * f) + 32 * 2 * d * d)
            + 6 * tokens * (32 * (6 * d * d + 2 * d * f) + V * d)
            + 12 * 32 * d * S_enc * frames + 12 * 32 * d * (128 + S_enc)
            * tokens)
    assert chip_smoke.train_flops(c, 8, 128)["model_flops"] == want
    assert T.count_params(c) == 1_601_606_400
