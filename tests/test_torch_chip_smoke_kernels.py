"""chip_smoke.py's logic on the CPU, at smoke size: the kernel phase's
helpers (3, 3b and 6): tolerances, bounds, cases and device-time
reduction.

The script itself needs a GPU; here its phases run with the smoke
configs on CPU tensors (the kernels' plain versions), at the
conversation and pool sizes the script uses on the card.  One of the
files ``tests/test_torch_chip_smoke_*.py``, split by phase."""
import pytest
import torch

from chip_smoke_served import ROOT  # noqa: E402,F401
import chip_smoke  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import block_copy as bc  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gla_scan as gla  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


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


def test_new_rows_bounds_follow_their_work():
    """qwen2-1.5b prefill (B 1, 12 heads, T 2048, D 128, causal, bf16):
    25.2 MB and 12.9 GFLOP over the visible pairs, bound by operations at
    0.0130 ms; zamba2-7b's SSD scan (112 heads, T 4096, N = P = chunk =
    64): 238.6 MB, bound by bytes at 0.0712 ms."""
    nbytes, flops = chip_smoke.flash_work(1, 12, 2048, 2048, 128, True)
    assert nbytes == 4 * 12 * 2048 * 128 * 2
    assert flops == 4 * 12 * 128 * 2048 * 2049 // 2
    ms, by = chip_smoke.bound_ms(nbytes, flops)
    assert by == "operations" and ms == pytest.approx(0.013035, rel=1e-4)
    _, full = chip_smoke.flash_work(1, 12, 2048, 2048, 128, False)
    assert full == 4 * 12 * 128 * 2048 * 2048
    # T != S: rows past S see all S keys
    assert chip_smoke.flash_work(1, 1, 4, 2, 1, True)[1] == 4 * (1 + 2 * 3)
    nbytes, flops = chip_smoke.gla_work(1, 112, 4096, 64, 64, 64)
    assert nbytes == 112 * 4096 * (4 * 64 * 2 + 4) + 112 * 64 * 64 * 4
    assert flops == 2 * 112 * 64 * (2 * 64 ** 3 + 64 * 65 // 2 * 128)
    ms, by = chip_smoke.bound_ms(nbytes, flops)
    assert by == "bytes" and ms == pytest.approx(0.071209, rel=1e-4)


def test_block_copy_case_moves_the_gather_chunk():
    """The per-block pairs and grouped runs of the 2-D case copy exactly
    the blocks the run gather stages, into the slab's layout (a smaller
    pool of the same block shape on the CPU)."""
    case = chip_smoke.copy_case(torch.device("cpu"), seed=1, nb=160, L=2)
    slab, total = ops.gather_swap_runs(case["pool"], case["runs"])
    c2 = chip_smoke.copy_2d_case(case)
    assert c2["si"].numel() == 4 * total and c2["g_src"].numel() == 4 * 3
    assert c2["run_blocks"] == 32
    want = slab.reshape(c2["n_dst"], c2["E"]).view(torch.int16)
    fresh = lambda: torch.zeros((c2["n_dst"], c2["E"]), dtype=torch.bfloat16)
    outs = (bc.block_copy(c2["src"], fresh(), c2["si"], c2["di"]),
            bc.block_copy_grouped(c2["src"], fresh(), c2["g_src"],
                                  c2["g_dst"], c2["g_len"],
                                  c2["run_blocks"]),
            ops.copy_block_runs(c2["src"], fresh(), c2["run_list"],
                                c2["dst_starts"]))
    for out in outs:
        assert torch.equal(out.view(torch.int16), want)


def test_flash_tolerance_fails_a_dropped_128_key_tile():
    """The flash check's per-element bound on causal prefill rows of 2048
    keys: one bf16 ulp passes, the late rows missing one 128-key tile
    fail."""
    q, k, v = chip_smoke.flash_case(1, 2, 2048, 128, torch.device("cpu"),
                                    seed=2048)
    ref = fa.flash_attention_plain(q, k, v)
    assert chip_smoke.attention_error(ref, ref, "flash_attention") == 0.0
    up = (ref.float() * (1 + 2 ** -8)).bfloat16()
    assert chip_smoke.attention_error(up, ref, "flash_attention") > 0
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * 128 ** -0.5
    rows = torch.arange(2048)[:, None]
    cols = torch.arange(2048)[None, :]
    dropped = (cols >= 1024) & (cols < 1152) & (rows >= 1152)
    s = s.masked_fill((cols > rows) | dropped, -1e30)
    short = (torch.softmax(s, dim=-1) @ v.float()).bfloat16()
    with pytest.raises(AssertionError, match="flash_attention: max abs"):
        chip_smoke.attention_error(short, ref, "flash_attention")


def _flash_tiled(q, k, v, split_p: bool):
    """Causal attention as a tensor-core kernel with 64-key tiles computes
    it: fp32 scores and online-softmax statistics (l from the fp32 p),
    and P.V with bf16 operands, P either rounded to one bf16 or split into
    hi = bf16(p) and lo = bf16(p - hi)."""
    T, D = q.shape[2], q.shape[3]
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:3] + (1,), -1e30)
    l = torch.zeros(q.shape[:3] + (1,))
    o = torch.zeros(qf.shape)
    rows = torch.arange(T)[:, None]
    for k0 in range(0, k.shape[2], 64):
        s = torch.einsum("bhtd,bhsd->bhts", qf, kf[:, :, k0:k0 + 64])
        s = (s * D ** -0.5).masked_fill(
            torch.arange(k0, k0 + 64)[None, :] > rows, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, k0:k0 + 64]
        if split_p:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, k0:k0 + 64]
        o = o * alpha + pv
        m = m_new
    return (o / l.clamp_min(1e-30)).bfloat16()


def test_flash_tolerance_fails_rounded_p_and_passes_split_p():
    """The flash check's per-element bound on causal prefill rows of 2048
    keys: rounding the softmax weights P to one bf16 before P.V (the
    usual FlashAttention-2 shortcut) fails it; splitting P into two bf16
    terms, as the card's kernel does, passes it."""
    q, k, v = chip_smoke.flash_case(1, 2, 2048, 128, torch.device("cpu"),
                                    seed=2048)
    ref = fa.flash_attention_plain(q, k, v)
    with pytest.raises(AssertionError, match="flash_attention: max abs"):
        chip_smoke.attention_error(_flash_tiled(q, k, v, split_p=False), ref,
                                   "flash_attention")
    split = _flash_tiled(q, k, v, split_p=True)
    assert chip_smoke.attention_error(split, ref, "flash_attention") < 0.01


def test_kernel_ms_reduces_profiler_device_events():
    """Mean device ms per call: the summed µs of every device event not
    named in ``skip`` (the L2 flush's kernels), over the call count; no
    event left, or a count that is not a multiple of the calls (an event
    lost), is an error."""
    from types import SimpleNamespace as NS

    def ev(name, start, end):
        return NS(name=name, time_range=NS(start=start, end=end))
    events = [ev("flush_fill", 0.0, 900.0), ev("flash_mma", 900.0, 960.0),
              ev("memset", 960.0, 965.0), ev("flush_fill", 1000.0, 1900.0),
              ev("flash_mma", 1900.0, 1980.0), ev("memset", 1980.0, 1990.0)]
    assert chip_smoke.kernel_ms(events, 2, {"flush_fill"}) == \
        pytest.approx((60 + 5 + 80 + 10) / 1e3 / 2)
    assert chip_smoke.kernel_ms(events, 1) == pytest.approx(1.955)
    with pytest.raises(AssertionError, match="recorded 0 device kernels"):
        chip_smoke.kernel_ms(events[:1], 1, {"flush_fill"})
    with pytest.raises(AssertionError, match="recorded 1 device kernels"):
        chip_smoke.kernel_ms(events[:2], 2, {"flush_fill"})


def test_kernel_ms_raises_where_a_flush_kernel_was_lost():
    """Given the flush's kernels per call, a session that lost one flush
    kernel is an error even where the call's own kernels still divide;
    the whole session gives the mean as without the count."""
    from types import SimpleNamespace as NS

    def ev(name, start, end):
        return NS(name=name, time_range=NS(start=start, end=end))
    events = [ev("flush_fill", 0.0, 900.0), ev("flash_mma", 900.0, 960.0),
              ev("flush_fill", 1000.0, 1900.0),
              ev("flash_mma", 1900.0, 1980.0)]
    assert chip_smoke.kernel_ms(events, 2, {"flush_fill"}, 1) == \
        pytest.approx((60 + 80) / 1e3 / 2)
    with pytest.raises(AssertionError, match="recorded 1 flush kernels"):
        chip_smoke.kernel_ms(events[1:], 2, {"flush_fill"}, 1)
    with pytest.raises(AssertionError, match="recorded 2 flush kernels"):
        chip_smoke.kernel_ms(events, 2, {"flush_fill"}, 2)


def test_remeasured_makes_a_lost_session_again_and_raises_the_last():
    """A measurement that raises ``AssertionError`` (a profiler session
    without its device events) is made again; the first result is kept;
    when every try fails, the last error is raised, not a number."""
    results = iter([AssertionError("recorded 0 device kernels"),
                    AssertionError("recorded 3 device kernels"), 0.25])

    def measure():
        r = next(results)
        if isinstance(r, Exception):
            raise r
        return r
    before = chip_smoke.remeasured.retries
    assert chip_smoke.remeasured(measure, tries=3) == 0.25
    assert chip_smoke.remeasured.retries == before + 2

    def lost():
        raise AssertionError(f"recorded 0 device kernels, call {next(n)}")
    n = iter(range(3))
    with pytest.raises(AssertionError, match="call 1"):
        chip_smoke.remeasured(lost, tries=2)
    with pytest.raises(ValueError):
        chip_smoke.remeasured(lambda: int("x"), tries=3)


def test_device_times_fall_back_to_events_where_the_profiler_is_empty(
        monkeypatch):
    """Every callable gets the CUDA events' reading; the profiler's is the
    device time where its sessions held their events, the events' where
    they all came back empty, and each reading names its source; a call
    without a library has no library times."""
    def kernel():
        pass

    def library():
        pass

    def profiled(fn, flush=None):
        if fn is library:
            raise AssertionError("the profiler recorded no device kernel "
                                 "for the L2 flush")
        return 0.5

    monkeypatch.setattr(chip_smoke, "device_ms", profiled)
    monkeypatch.setattr(chip_smoke, "queued_ms",
                        lambda fn, flush=None: 0.75 if fn is kernel else 2.0)
    timed = {"ms": 1.0, "fns": (kernel, library)}
    chip_smoke.add_device_times(timed, flush=None)
    assert "fns" not in timed
    assert (timed["device_ms"], timed["device_ms_by"],
            timed["events_ms"]) == (0.5, "profiler", 0.75)
    assert (timed["library_device_ms"], timed["library_device_ms_by"],
            timed["library_events_ms"]) == (2.0, "cuda_events", 2.0)
    alone = {"fns": (kernel, None)}
    chip_smoke.add_device_times(alone, flush=None)
    assert alone["library_device_ms"] is None
    assert alone["library_events_ms"] is None
    assert alone["library_device_ms_by"] is None


def test_gla_bounds_pass_one_ulp_and_fail_a_skipped_chunk():
    """The scan check's bounds on zamba2-7b's head shape (2 heads, T 512
    on the CPU): y one bf16 ulp up passes; a scan that drops one chunk's
    keys from the state fails on y and S."""
    q, k, v, logw = chip_smoke.gla_case(torch.device("cpu"), 3, H=2, T=512)
    y, s = gla.gla_scan_scalar_plain(q, k, v, logw)
    assert chip_smoke.gla_errors(y, s, y, s) == (0.0, 0.0)
    up = (y.float() * (1 + 2 ** -8)).bfloat16()
    assert chip_smoke.gla_errors(up, s, y, s)[0] > 0
    k2 = k.clone()
    k2[:, :, 448:] = 0                      # the last chunk adds nothing
    y2, s2 = gla.gla_scan_scalar_plain(q, k2, v, logw)
    with pytest.raises(AssertionError, match="y max abs"):
        chip_smoke.gla_errors(y2, s, y, s)
    with pytest.raises(AssertionError, match="S max abs"):
        chip_smoke.gla_errors(y, s2, y, s)


def test_engine_attention_case_holds_the_engine_bucket():
    """The engine's decode bucket for phases 3 and 6: B 8 over 64 pages of
    16, contexts spread over 256-600, no ctx-0 or trash row; its bytes are
    the walked K and V with q, the output and the table, bound by bytes."""
    case = chip_smoke.attention_case(8, 64, torch.device("cpu"), seed=1,
                                     ctx_range=(256, 600))
    ctx = case["ctx"].tolist()
    assert ctx[0] == 256 and ctx[-1] == 600 and ctx == sorted(ctx)
    assert int(case["bt"].max()) < case["k"].shape[0] - 1
    nbytes, flops = chip_smoke.attention_work(case)
    walked = sum(ctx)
    assert nbytes == (walked * 2 * 128 * 4 + 2 * 8 * 12 * 128 * 2
                      + 8 * 64 * 4 + 8 * 4)
    assert flops == 4 * walked * 12 * 128
    assert chip_smoke.bound_ms(nbytes, flops)[1] == "bytes"
    args = [case[n] for n in ("q", "k", "v", "bt", "ctx", "scale", "ppcb")]
    out = pa.paged_attention(*args)
    assert out.shape == (8, 12, 128) and bool(torch.isfinite(out).all())


def test_ops_named_sums_the_paged_attention_kernels():
    from types import SimpleNamespace as NS

    def ev(name, start, end):
        return NS(name=name, time_range=NS(start=start, end=end))
    events = [ev("paged_attention_split_kernel", 0.0, 5.0),
              ev("nvjet_gemm", 5.0, 50.0),
              ev("paged_attention_combine_kernel", 50.0, 52.0),
              ev("paged_attention_split_kernel", 60.0, 66.0)]
    assert chip_smoke.ops_named(events, "paged_attention") == {
        "paged_attention_split_kernel": [2, pytest.approx(0.011)],
        "paged_attention_combine_kernel": [1, pytest.approx(0.002)]}
    assert chip_smoke.ops_named(events, "flash") == {}


def test_graph_check_catches_a_replay_that_differs_from_eager(monkeypatch):
    """A replay that writes a wrong context length (as a graph over a
    stale tensor would) fails the ``graphs`` phase's byte comparison."""
    from repro_torch.core import decode_runner as dr
    from repro_torch.core.decode_runner import DecodeRequestView
    real = dr._StepGraph.replay

    def off_by_one(graph, tensors):
        nxt = real(graph, tensors)
        tensors[dr.STEP_TENSORS.index("context_lens")].add_(1)
        return nxt
    monkeypatch.setattr(dr._StepGraph, "replay", off_by_one)
    cfg = get_smoke_config("qwen2-1.5b")
    bundle = {"cfg": cfg, "params": T.init_params(cfg, seed=0,
                                                  device="cpu")}
    runner = dr.DecodeRunner(bundle, block_size=4, trash_block=7)
    pool = torch.zeros((cfg.n_layers, 2, 8, 4, cfg.n_kv_heads,
                        cfg.resolved_head_dim), dtype=torch.bfloat16)
    hist = [3]
    with chip_smoke.replays_held_to_eager() as held:
        pool = runner.decode([DecodeRequestView(0, [0], hist)], pool)
        with pytest.raises(AssertionError, match="differs from the eager"):
            runner.decode([DecodeRequestView(0, [0], hist)], pool)
    assert held == [{"bucket": [1, 1], "sampled": False, "byte_equal": {
        "nxt": True, "pool": True, "context_lens": False, "tokens": True}}]
    assert dr._StepGraph.replay is off_by_one      # restored on exit
