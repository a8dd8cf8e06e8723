"""chip_smoke.py's logic on the CPU, at smoke size: the swap phase (3c),
the held engine runs' swap counts (4), the exact-shape oracle (5a) and
the reading of the overlap probe's profiler trace (5g).

The script itself needs a GPU; here its phases run with the smoke
configs on CPU tensors (the kernels' plain versions), at the
conversation and pool sizes the script uses on the card.  One of the
files ``tests/test_torch_chip_smoke_*.py``, split by phase."""
import pytest
import torch

from chip_smoke_served import SIZES  # noqa: E402,F401
import chip_smoke  # noqa: E402
from repro_torch.cache.paged import PagedPools  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

SMALL = {"narrow": dict(L=2, Hkv=2, D=8), "wide": dict(L=1, Hkv=4, D=16)}


def test_swap_phase_moves_one_swap_three_ways_byte_equal():
    """Every way at both layouts: each run's host and device blocks
    equal the pool before (checked inside), a time and a rate per leg
    and run; no host link to time off the card."""
    out = chip_smoke.swap_phase("cpu", layouts=SMALL, repeats=2)
    assert set(out) == set(SMALL)
    for arch, rec in out.items():
        assert rec["blocks"] == 64 and rec["runs"] == [[3, 20], [40, 12],
                                                       [100, 32]]
        assert rec["bytes"] == 64 * rec["block_bytes"]
        assert set(rec["ways"]) == {"per_block", "one_call", "staged"}
        for way in rec["ways"].values():
            for key in ("out_ms", "in_ms", "out_gb_s", "in_gb_s"):
                assert len(way[key]) == 2 and min(way[key]) > 0
        assert rec["link"] == {"d2h_ms": [], "h2d_ms": []}


def test_swap_phase_catches_a_swap_in_that_restores_other_bytes(
        monkeypatch):
    real = PagedPools.copy_in

    def wrong(self, cpu_blocks, gpu_blocks):
        real(self, cpu_blocks, gpu_blocks)
        self.gpu[:, :, gpu_blocks[-1]] += 1
    monkeypatch.setattr(PagedPools, "copy_in", wrong)
    with pytest.raises(AssertionError, match="per_block: the device blocks"):
        chip_smoke.swap_phase("cpu", layouts={"narrow": SMALL["narrow"]},
                              repeats=1)


def test_swap_phase_catches_a_swap_out_that_stores_other_bytes(monkeypatch):
    real = PagedPools.copy_out_staged

    def wrong(self, gpu_runs, cpu_blocks, **kw):
        real(self, gpu_runs, cpu_blocks, **kw)
        self.cpu[:, :, cpu_blocks[0]] ^= 1
    monkeypatch.setattr(PagedPools, "copy_out_staged", wrong)
    with pytest.raises(AssertionError, match="staged: the host blocks"):
        chip_smoke.swap_phase("cpu", layouts={"narrow": SMALL["narrow"]},
                              repeats=1)


@pytest.fixture(scope="module")
def held_runs():
    """The engine phase's two runs at smoke size, both with swap tasks
    held to the simulated clock, as the script now runs them."""
    cfg = get_smoke_config("qwen2-1.5b")
    bundle = {"cfg": cfg, "params": T.init_params(cfg, seed=0,
                                                  device="cpu")}
    convs = chip_smoke.conversations(8, (256, 288, 320, 352),
                                     (96, 128, 160), max_tokens=32)
    runs = []
    for _ in range(2):
        with chip_smoke.swaps_follow_the_clock():
            eng, _, _, swaps = chip_smoke.run_engine(bundle, convs, **SIZES)
        runs.append((eng, swaps))
    return bundle, convs, runs


def test_held_engine_runs_repeat_their_swaps_and_tokens(held_runs):
    _, convs, ((a, sa), (b, sb)) = held_runs
    made = chip_smoke.check_engine(a, convs, sa)
    counts = (made["swap_out_calls"], made["swap_in_calls"])
    assert chip_smoke.check_engine(b, convs, sb, expect_swaps=counts)
    assert a._token_hist_by_conv == b._token_hist_by_conv
    assert made["fenced_swap_ins"] == 0          # no stream off the card
    with pytest.raises(AssertionError, match="expected"):
        chip_smoke.check_engine(b, convs, sb,
                                expect_swaps=(counts[0] + 1, counts[1]))
    assert chip_smoke.ENGINE_SWAPS == (81, 156)
    assert chip_smoke.MOE_SWAPS == (74, 142)


def test_oracle_phase_holds_the_engines_conversations(held_runs):
    """The phase's record over two of the conversations (all eight are
    held to the oracle in tests/test_torch_exact_shape.py)."""
    bundle, convs, ((eng, _), _) = held_runs
    out = chip_smoke.check_oracle(eng, bundle, convs[:2])
    assert out["conversations"] == 2
    assert out["equal"] + len(out["near_ties"]) == 2
    assert all(d["logit_gap"] < chip_smoke.NEAR_TIE
               for d in out["near_ties"])
    assert out["generated"] > 0


def test_oracle_phase_catches_a_wrong_token(held_runs):
    bundle, convs, ((eng, _), _) = held_runs
    hist = eng._token_hist_by_conv[0]
    pos = convs[0].turns[0].prompt_tokens          # its first token
    saved = hist[pos]
    hist[pos] = (saved + 1) % bundle["cfg"].vocab_size
    try:
        with pytest.raises(AssertionError, match="exact-shape oracle"):
            chip_smoke.check_oracle(eng, bundle, convs[:1], tol=1e-9)
    finally:
        hist[pos] = saved


def _op(cat, name, ts, dur, stream, nbytes=None):
    args = {"stream": stream}
    if nbytes is not None:
        args["bytes"] = nbytes
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _trace(pipelined: bool):
    """A replay (stream 7, 0-8000 µs) beside four sub-slabs: uploads on
    stream 20, scatters (and their index copies) on stream 21."""
    ev = [_op("kernel", f"replay_kernel_{i}", 100 * i, 90, 7)
          for i in range(80)]
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 0,
               "dur": 50000})
    for k in range(4):
        up = 1000 + 3000 * k
        ev.append(_op("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", up,
                      1000, 20, 32 << 20))
        sc = (up + 3000 if pipelined else up + 1000) + 10
        ev.append(_op("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", sc,
                      2, 21, 96))
        ev.append(_op("kernel", "void copy_runs_kernel<uint4>(...)", sc + 5,
                      60, 21))
    return ev


def test_overlap_from_trace_reads_the_pipeline():
    got = chip_smoke.overlap_from_trace(_trace(True), 32 << 20)
    assert got["sub_slabs"] == 4 and got["replay_ops"] == 80
    assert got["upload_next_before_scatter_ends"] == [True, True, True]
    assert got["swap_ops"] == 12
    # uploads 1000-2000, 4000-5000, 7000-8000 overlap the replay's
    # kernels (90 of every 100 µs up to 7990); the first scatter's index
    # copy and kernel (4010-4075) lie inside the second upload
    assert got["overlap_ms"] == pytest.approx(2.7)
    assert got["replay_span_ms"] == pytest.approx(7.99)
    assert got["swap_end_after_replay_start_ms"] == pytest.approx(
        (1000 + 9000 + 3000 + 10 + 5 + 60) / 1e3)
    serial = chip_smoke.overlap_from_trace(_trace(False), 32 << 20)
    assert serial["upload_next_before_scatter_ends"] == [False] * 3


def test_overlap_from_trace_refuses_a_trace_without_the_swap():
    ev = [e for e in _trace(True) if "copy_runs" not in e["name"]]
    with pytest.raises(AssertionError, match="slab uploads"):
        chip_smoke.overlap_from_trace(ev, 32 << 20)
    ev = [e for e in _trace(True) if e.get("args", {}).get("stream") != 7]
    with pytest.raises(AssertionError, match="no operation of the replay"):
        chip_smoke.overlap_from_trace(ev, 32 << 20)


def test_earlier_staged_seconds_name_their_runs():
    assert chip_smoke.EARLIER_STAGED_S["qwen2-1.5b"]["copy_in_staged"] \
        == 0.463
    assert chip_smoke.EARLIER_STAGED_S["olmoe-1b-7b"]["copy_in_staged"] \
        == 2.098
    assert set(chip_smoke.SWAP_LAYOUTS) == {"qwen2-1.5b", "olmoe-1b-7b"}
    blocks = {k: v["L"] * 2 * 16 * v["Hkv"] * v["D"] * 2
              for k, v in chip_smoke.SWAP_LAYOUTS.items()}
    assert blocks == {"qwen2-1.5b": 448 * 1024, "olmoe-1b-7b": 2 << 20}
    assert torch.tensor(0).device.type == "cpu"
