"""chip_smoke.py's logic on the CPU, at smoke size: the mesh phase (5k),
and planted faults its checks must catch.

The script itself needs a GPU; here the phase runs with the smoke configs
on CPU tensors (the kernels' plain versions), every shard on the CPU.
One of the files ``tests/test_torch_chip_smoke_*.py``, split by phase."""
import pytest

from chip_smoke_served import ROOT  # noqa: E402,F401
import chip_smoke  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import paged  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def test_mesh_phase_on_the_cpu():
    """The mesh phase with qwen2-1.5b's reduced width on (1, 2) and
    olmoe-1b-7b's on (1, 4): every run finishes with preemption and every
    conversation swapped both ways, one transfer per staged chunk per
    shard, each bucket's first replay equals its eager step, the
    one-device run's graph counts, tokens equal to the one-device run's
    or near-ties, the oracle step, the per-shard attention, the staged
    swap across meshes, the sampled batch, and both refusals."""
    out = chip_smoke.mesh_phase(
        "cpu", qcfg=get_smoke_config("qwen2-1.5b"),
        ocfg=get_smoke_config("olmoe-1b-7b"))
    for part, n in (("qwen2", 2), ("olmoe", 4)):
        o = out[part]
        assert o["mesh_shape"] == [1, n] and o["devices"] == ["cpu"] * n
        assert o["tokens"] == 512 and o["preemptions"] > 0
        t = o["transfers"]
        assert t["n_shards"] == n and t["staged_out_calls"] > 0
        assert t["d2h_transfers"] == n * t["staged_out_calls"]
        assert t["h2d_transfers"] == n * t["staged_in_calls"]
        assert o["replays_checked"] and all(
            all(c["byte_equal"].values()) for c in o["replays_checked"])
        assert o["tokens_vs_one_device"]["equal_one_device"] > 0
        assert o["oracle"]["rows"]
        # the plain versions run here: no kernel is launched
        assert o["launches"] == {"paged_attention": 0,
                                 "block_gather_runs": 0,
                                 "block_scatter_runs": 0}
        assert o["launches_per_shard"]["paged_attention"] == [0] * n
        assert len(o["attention_per_shard"]["max_abs_err_by_shard"]) == n
        legs = o["swap_across_meshes"]["legs"]
        assert legs[f"mesh_1x{n}"]["d2h_transfers"] == n
        assert legs["one_device"]["d2h_transfers"] == 1
    s = out["qwen2"]["sampling"]
    assert s["sampled_graphs"] > 0 and s["sampled_generated"] == 128
    assert any(c["sampled"] for c in s["replays_checked"])
    assert "2 devices" in out["refusals"]["two_cuda_devices"]
    assert "devices" in out["refusals"]["default_devices_too_few"]


@pytest.fixture(scope="module")
def mesh_run():
    """A (1, 2) engine run of qwen2-1.5b's reduced width on the CPU: the
    engine, its fullest replay at its last bucket, the serving params."""
    cfg = get_smoke_config("qwen2-1.5b")
    params = T.init_params(cfg, seed=0, device="cpu")
    bundle = {"cfg": cfg, "params": params, "mesh_devices": ["cpu"] * 2}
    convs = chip_smoke.conversations(4, (64, 96), (32,), max_tokens=8)
    with chip_smoke.fullest_replays() as snaps:
        eng, _, _, _ = chip_smoke.run_engine(
            bundle, convs, gpu_blocks=24, cpu_blocks=256, max_running=4,
            mesh=(1, 2))
    bucket = (eng.runner.batch_bucket, eng.runner._pages_bucket)
    snap = snaps.get(bucket) or max(snaps.values(),
                                    key=lambda s: s["active"])
    return eng, snap, T.serving_params(params)


def test_mesh_checks_pass_on_a_sound_run(mesh_run):
    eng, snap, params = mesh_run
    chip_smoke.mesh_transfers(eng.pools, 2)
    assert chip_smoke.mesh_oracle(eng, snap, params)["max_abs_logit_err"] \
        <= chip_smoke.MESH_LOGIT_ATOL


def _dropped(parts, dim):
    """A fault: the second shard's heads lost (zeros in their place)."""
    if len(parts) == 1:
        return parts[0]
    import torch
    return torch.cat([parts[0]] + [torch.zeros_like(p) for p in parts[1:]],
                     dim=dim)


def _swapped(parts, dim):
    """A fault: the shards' head outputs concatenated in reverse order."""
    if len(parts) == 1:
        return parts[0]
    import torch
    return torch.cat(parts[::-1], dim=dim)


@pytest.mark.parametrize("fault", [_dropped, _swapped])
def test_mesh_oracle_catches_a_planted_head_fault(mesh_run, fault,
                                                  monkeypatch):
    eng, snap, params = mesh_run
    monkeypatch.setattr(paged, "unshard", fault)
    with pytest.raises(AssertionError, match="logits"):
        chip_smoke.mesh_oracle(eng, snap, params)


@pytest.mark.parametrize("counter", ["d2h_transfers", "h2d_transfers"])
def test_mesh_transfers_catch_a_count_off_by_one(mesh_run, counter):
    eng, _, _ = mesh_run
    setattr(eng.pools, counter, getattr(eng.pools, counter) + 1)
    try:
        with pytest.raises(AssertionError, match="one per staged chunk"):
            chip_smoke.mesh_transfers(eng.pools, 2)
    finally:
        setattr(eng.pools, counter, getattr(eng.pools, counter) - 1)
    chip_smoke.mesh_transfers(eng.pools, 2)
