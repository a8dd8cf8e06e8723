"""chip_smoke.py's logic on the CPU, at smoke size: the moe phase (5g) and
its step bound.

The script itself needs a GPU; here its phases run with the smoke
configs on CPU tensors (the kernels' plain versions), at the
conversation and pool sizes the script uses on the card.  One of the
files ``tests/test_torch_chip_smoke_*.py``, split by phase."""
import torch

from chip_smoke_served import ROOT  # noqa: E402,F401
import chip_smoke  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def test_moe_phase_on_the_cpu(tmp_path):
    """The moe phase at olmoe-1b-7b's reduced width on the CPU, at a
    capacity factor of 1.0 (pairs dropped): both runs finish with
    preemption and every conversation swapped both ways, each bucket's
    first replay equals its eager step, the two runs' tokens are equal,
    the oracle step agrees (the plain version on both sides here), and
    the launcher's ``--device cpu`` run exits 0."""
    import dataclasses
    cfg = get_smoke_config("olmoe-1b-7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))
    out = chip_smoke.moe_phase("cpu", tmp_path, cfg=cfg)
    assert out["arch"] == "olmoe-1b-7b-smoke"
    assert out["tokens"] == 512 and out["preemptions"] > 0
    assert out["replays_checked"] and all(
        all(c["byte_equal"].values()) for c in out["replays_checked"])
    assert out["oracle"]["rows"] and out["oracle"]["free_routing_flips"] == 0
    assert out["oracle"]["max_abs_logit_err"] == 0.0
    assert out["launches"] == {"paged_attention": 0, "block_gather_runs": 0,
                               "block_scatter_runs": 0}
    assert out["launcher"]["total_tokens"] > 0
    assert out["unheld_wall_s"] > 0 and out["clock_hold_wait_s"] >= 0
    routed = out["oracle"]["routed_experts_per_layer"]
    assert len(routed) == cfg.n_layers
    assert all(0 < n <= cfg.moe.n_experts for n in routed)


def test_moe_step_bytes_counts_weights_and_walked_kv():
    """olmoe-1b-7b's decode-step bound at full width, from shapes: 12.9 GB
    of bf16 experts, 0.54 GB of bf16 attention, the fp32 router, norms and
    lm_head, and each row's walked K/V (128 KiB a token)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("olmoe-1b-7b")
    d, E, f, L = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_expert_ff, 16
    meta = {"embed": {"table": torch.empty((cfg.vocab_size, d),
                                           device="meta")},
            "lm_head": {"table": torch.empty((cfg.vocab_size, d),
                                             device="meta")},
            "final_norm": {"scale": torch.empty((d,), device="meta")},
            "layers": {"attn": {n: torch.empty((L, d, d), device="meta",
                                               dtype=torch.bfloat16)
                                for n in ("wq", "wk", "wv", "wo")},
                       "ffn": {"router": torch.empty((L, d, E),
                                                     device="meta"),
                               **{n: torch.empty((L, E, d, f), device="meta",
                                                 dtype=torch.bfloat16)
                                  for n in ("w_gate", "w_up", "w_down")}},
                       "ln1": {"scale": torch.empty((L, d), device="meta")},
                       "ln2": {"scale": torch.empty((L, d), device="meta")}}}
    ctx = torch.tensor([0, 99])
    got = chip_smoke.moe_step_bytes(meta, dataclasses.replace(cfg), ctx)
    weights = (L * 3 * E * d * f * 2 + L * 4 * d * d * 2 + L * d * E * 4
               + cfg.vocab_size * d * 4 + d * 4 + 2 * L * d * 4)
    kv = (1 + 100 + 2) * 128 * 1024
    assert got == weights + 2 * d * 4 + kv
    assert 4.1 < chip_smoke.bound_ms(got, 0)[0] < 4.2
    # the routed bound reads only the experts the step reaches: 40 of 64
    # in every layer leaves out 24 experts' three matrices per layer
    routed = chip_smoke.moe_step_bytes(meta, cfg, ctx, [40] * L)
    assert routed == got - L * 24 * 3 * d * f * 2
