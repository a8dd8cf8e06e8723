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
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gla_scan as gla  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

SIZES = dict(gpu_blocks=160, cpu_blocks=1024, max_running=8)


@pytest.fixture(scope="module")
def served_held():
    """The engine phase at smoke size on the CPU, with the ``graphs``
    check over it: (bundle, convs, engine, swaps) and the checked
    buckets."""
    cfg = get_smoke_config("qwen2-1.5b")
    bundle = {"cfg": cfg, "params": T.init_params(cfg, seed=0,
                                                  device="cpu")}
    convs = chip_smoke.conversations(8, (256, 288, 320, 352),
                                     (96, 128, 160), max_tokens=32)
    with chip_smoke.replays_held_to_eager() as held:
        eng, wall, host, swaps = chip_smoke.run_engine(bundle, convs,
                                                       **SIZES)
    assert wall > 0 and set(host) == {"decode", "flush", "_scatter_rows",
                                      "prefill_chunk_compute",
                                      "copy_out_staged", "copy_in_staged"}
    return (bundle, convs, eng, swaps), held


@pytest.fixture(scope="module")
def served(served_held):
    return served_held[0]


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


def test_engine_phase_replays_one_step_variant_per_bucket(served_held):
    """Every decode step is a bucket's first (eager) step or a replay of
    its variant; one variant per bucket rebuild; and the first replay at
    each bucket was held against the eager step (``graphs`` phase)."""
    (_, convs, eng, swaps), held = served_held
    stats = chip_smoke.check_engine(eng, convs, swaps)
    assert stats["eager_steps"] + stats["graph_replays"] == \
        stats["decode_steps"]
    assert stats["graphs_captured"] == eng.runner.stats.rebuilds >= 1
    assert stats["batch_bucket"] == 8
    assert 1 <= len(held) <= stats["graphs_captured"]
    assert held[-1]["bucket"][0] == 8
    assert all(all(c["byte_equal"].values()) for c in held)


def test_engine_phase_catches_a_miscounted_step(served, monkeypatch):
    _, convs, eng, swaps = served
    monkeypatch.setattr(eng.runner.stats, "graph_replays",
                        eng.runner.stats.graph_replays - 1)
    with pytest.raises(AssertionError, match="replayed"):
        chip_smoke.check_engine(eng, convs, swaps)


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


# ---------------------------------------------------------------------------
# phases 5b (sampling) and 5d (serve), at smoke size on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sampled_held(served):
    """The sampling phase's first run, with the ``graphs`` check over it:
    (engine, requests, checked variants)."""
    bundle = served[0]
    with chip_smoke.replays_held_to_eager() as held:
        eng, convs = chip_smoke.run_sampling(bundle)
    return eng, convs, held


def test_sampling_phase_serves_both_variants(served, sampled_held):
    bundle = served[0]
    eng, convs, held = sampled_held
    stats = chip_smoke.check_sampling(eng, convs)
    assert stats["sampled_graphs"] >= 1 and stats["buckets"] >= 1
    assert any(c["sampled"] for c in held)
    assert all(all(c["byte_equal"].values()) for c in held)
    for c in convs:
        if c.conv_id % 2:
            r = chip_smoke.check_sampled_tokens(eng, bundle, c,
                                                chip_smoke.SAMPLING)
            assert r["equal"] + len(r["near_ties"]) == r["generated"] == 32
        else:
            r = chip_smoke.check_tokens(eng, bundle, c)
            assert r["max_gap"] < r["tolerance"]
    again, _ = chip_smoke.run_sampling(bundle)
    assert again._token_hist_by_conv == eng._token_hist_by_conv
    plain, _ = chip_smoke.run_sampling(bundle, sampling=None)
    assert plain.runner.stats.sampled_graphs == 0
    for c in convs:
        same = plain._token_hist_by_conv[c.conv_id] == \
            eng._token_hist_by_conv[c.conv_id]
        assert same == (c.conv_id % 2 == 0)
    assert chip_smoke.threefry_on_card_equals_cpu("cpu", vocab=1024) \
        == 8 * 1024


def test_sampling_phase_catches_a_wrong_sampled_token(served,
                                                      sampled_held):
    """The least likely token in place of a drawn one is no near-tie."""
    import torch as th
    from repro_torch.models import transformer as T
    bundle = served[0]
    eng, convs, _ = sampled_held
    conv = convs[1]
    hist = eng._token_hist_by_conv[1]
    i = conv.turns[0].prompt_tokens + 5
    with th.no_grad():
        logits, _ = T.forward_seq(bundle["params"], bundle["cfg"],
                                  th.tensor([hist[:i]]))
    saved = hist[i]
    hist[i] = int(logits[0, -1].argmin())
    try:
        with pytest.raises(AssertionError, match="no near-tie"):
            chip_smoke.check_sampled_tokens(eng, bundle, conv,
                                            chip_smoke.SAMPLING, tol=1e-9)
    finally:
        hist[i] = saved


def test_serve_phase_runs_the_launcher(tmp_path):
    """The serve phase's two launcher runs, on the CPU at the reduced
    width with two conversations: both policies report, the event log is
    well-formed, and no hand-written kernel launched (the plain versions
    run on the CPU)."""
    out = chip_smoke.serve_phase(tmp_path, device="cpu", conversations=2)
    pols = out["replay"]["policies"]
    assert set(pols) == {"vllm", "fastswitch"}
    assert all(p["total_tokens"] > 0 and p["callstack_wall_s"] > 0
               for p in pols.values())
    assert pols["fastswitch"]["kernel_launches"]["paged_attention"] == 0
    assert out["online_smoke"]["events"] > 0


def test_serve_phase_fails_on_a_failed_launcher_run(tmp_path):
    # ``--serve`` serves now: a policy the launcher does not know fails
    with pytest.raises(AssertionError, match="exited"):
        chip_smoke.run_launcher(["--policy", "no-such-policy"], tmp_path)


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
    logits, _ = T.forward_seq(bundle["params"], bundle["cfg"], toks)
    worst = int(logits[0, -1].argmin())
    with pytest.raises(AssertionError, match="below the dense maximum"):
        chip_smoke.stream_checks(bundle, [[(prompt, [worst])]])


def test_serve_frontend_phase_boots_the_launcher():
    out = chip_smoke.serve_frontend_phase("cpu")
    assert out["tokens"] == 4 and out["finish"] == "length"
    assert out["stdout"][0].startswith("frontend: 2 real replica(s) on ")
    assert out["stdout"][-1] == "frontend: interrupted, shutting down"


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


def test_first_divergence_names_the_position_and_gap(served):
    bundle = served[0]
    a = list(range(5, 25))
    assert chip_smoke.first_divergence(bundle, a, a + [1]) is None
    pos, gap = chip_smoke.first_divergence(bundle, a + [7], a + [8])
    assert pos == len(a) and gap >= 0.0


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
