"""Card tests: the staged swap plane on the pool's own CUDA streams.

A swap-out's gather waits for the event recorded when it was issued, and
for nothing launched after; a swap-in's uploads and scatters run beside
the caller's stream and wait only for the release events of their target
blocks; each staged call returns once its own last event has completed.
To make an ordering fault show, the tests stall a stream first with
``torch.cuda._sleep`` (a kernel that spins for a number of clock cycles),
so a copy that does not wait would run ahead of the work it must follow.
Also: swap work from another thread while a CUDA graph is being captured
stays legal and out of the graph, 200 replays beside swaps from four
threads leave every byte where a host-side shadow says, and the baseline
plane (``copy_out``, ``copy_in``, ``write_tokens``) gives the CPU's bytes.

Marked ``gpu``; each test skips when ``torch.cuda.is_available()`` is
false (decided in the ``cuda`` fixture, never at import):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_swap_streams.py
"""
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.cache.paged import PagedPools, PoolSpec
from repro_torch.configs import get_config
from repro_torch.core.decode_runner import DecodeRequestView, DecodeRunner
from repro_torch.models import transformer as T

pytestmark = pytest.mark.gpu

# ~20-40 ms of spinning at the H100's clocks: far longer than any copy here
STALL = 60_000_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _pools(device, nb=96, nc=96, L=2, Hkv=2, D=128, seed=0):
    pools = PagedPools(PoolSpec(n_layers=L, n_kv_heads=Hkv, head_dim=D,
                                block_size=16, num_gpu_blocks=nb,
                                num_cpu_blocks=nc), device=device)
    pools.gpu.normal_(generator=torch.Generator(device=device)
                      .manual_seed(seed))
    torch.cuda.synchronize()
    return pools


def _runner_setup(device, n_layers=1, n_cpu=16):
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=n_layers)
    bundle = {"cfg": cfg, "params": T.init_params(cfg, seed=0,
                                                  device=device)}
    pools = PagedPools(PoolSpec.from_config(cfg, 64, n_cpu), device=device)
    pools.gpu.normal_(generator=torch.Generator(device=device)
                      .manual_seed(1))
    runner = DecodeRunner(bundle, block_size=16, trash_block=63)
    return cfg, pools, runner


def _step(runner, pools, hist, blocks):
    runner.flush()
    pools.gpu = runner.decode([DecodeRequestView(0, blocks, hist)],
                              pools.gpu)


def test_swap_out_right_after_a_replay_reads_its_last_token(cuda):
    """The replay writing a row's K/V at slot ``ctx`` is queued behind a
    stall; a swap-out issued right after it from a worker thread, after
    the event recorded then, lands that K/V in the host pool.  The same
    swap-out after an event that does not cover the replay reads the
    slot's old bytes: the test sees the difference."""
    cfg, pools, runner = _runner_setup(cuda)
    hist = list(np.random.default_rng(0).integers(1, cfg.vocab_size, 40))
    blocks = [4, 5, 6]
    for _ in range(4):                       # eager, capture, replays
        _step(runner, pools, hist, blocks)
    runner.flush()
    torch.cuda.synchronize()
    ctx = len(hist) - 1
    blk, off = blocks[ctx // 16], ctx % 16
    old = pools.gpu[:, :, blk, off].clone()
    # a first swap-out loads the copy kernels' module and fills the
    # allocators' caches (a module load synchronises the device)
    pools.copy_out_staged([(blk, 1)], [5])
    torch.cuda.synchronize()
    torch.cuda._sleep(STALL)
    _step(runner, pools, hist, blocks)       # writes slot ctx, in flight
    written = pools.compute_event()
    early = torch.cuda.Event()
    early.record(pools._out_stream)          # covers nothing of the replay
    with ThreadPoolExecutor(1) as ex:
        ex.submit(pools.copy_out_staged, [(blk, 1)], [4],
                  after=early).result()
        ex.submit(pools.copy_out_staged, [(blk, 1)], [3],
                  after=written).result()
    torch.cuda.synchronize()
    now = pools.gpu[:, :, blk, off]
    assert not torch.equal(_bits(now), _bits(old))
    host = torch.from_numpy(pools.cpu[:, :, 3, off].view(np.int16))
    assert torch.equal(_bits(host), _bits(now.cpu().view(torch.int16)))
    stale = torch.from_numpy(pools.cpu[:, :, 4, off].view(np.int16))
    assert torch.equal(_bits(stale), _bits(old.cpu().view(torch.int16)))


def test_replay_after_a_swap_in_future_reads_the_uploaded_bytes(cuda):
    """A swap-in from a worker thread whose uploads are stalled on the
    pool's h2d stream: once its future is done, a replay launched over
    the swapped-in blocks gives the tokens and pool of the same step
    after a full device synchronise."""
    cfg, pools, runner = _runner_setup(cuda)
    hist = list(np.random.default_rng(1).integers(1, cfg.vocab_size, 33))
    blocks = [10, 11, 12]
    for _ in range(3):
        _step(runner, pools, hist, blocks)
    runner.flush()
    pools.copy_out_staged([(10, 3)], [0, 1, 2])
    saved_hist = list(hist)
    pools.gpu[:, :, 10:13] = 0
    torch.cuda.synchronize()
    with torch.cuda.stream(pools._h2d_stream):
        torch.cuda._sleep(STALL)
    with ThreadPoolExecutor(1) as ex:
        ex.submit(pools.copy_in_staged, [0, 1, 2], [(10, 3)]).result()
    _step(runner, pools, hist, blocks)
    runner.flush()
    torch.cuda.synchronize()
    got_pool = pools.gpu.clone()
    # the same step again from the same state, everything synchronised
    pools.gpu[:, :, 10:13] = 0
    torch.cuda.synchronize()
    pools.copy_in_staged([0, 1, 2], [(10, 3)])
    torch.cuda.synchronize()
    hist2 = list(saved_hist)
    runner2 = DecodeRunner(runner.mb, block_size=16, trash_block=63)
    _step(runner2, pools, hist2, blocks)
    runner2.flush()
    torch.cuda.synchronize()
    assert hist[-1] == hist2[-1]
    assert torch.equal(_bits(got_pool), _bits(pools.gpu))


def test_a_block_swapped_out_then_reused_by_a_swap_in_of_another_thread(
        cuda):
    """Thread A swaps blocks out behind a stall of the out stream; once
    its future is done (as the engine's conflict sync waits), thread B
    swaps other host blocks into the same device blocks: A's host copy
    holds the blocks' bytes before, the pool B's."""
    pools = _pools(cuda)
    before = pools.gpu[:, :, 20:28].clone()
    pools.cpu[:, :, 40:48] = np.random.default_rng(2).integers(
        0, 0x3F00, pools.cpu[:, :, 40:48].shape, dtype=np.uint16)
    want_in = pools.cpu[:, :, 40:48].copy()
    with torch.cuda.stream(pools._out_stream):
        torch.cuda._sleep(STALL)
    with ThreadPoolExecutor(1) as a, ThreadPoolExecutor(1) as b:
        a.submit(pools.copy_out_staged, [(20, 8)],
                 list(range(8)), after=pools.compute_event()).result()
        b.submit(pools.copy_in_staged, list(range(40, 48)),
                 [(20, 8)]).result()
    torch.cuda.synchronize()
    host = torch.from_numpy(pools.cpu[:, :, 0:8].view(np.int16))
    assert torch.equal(_bits(host), _bits(before.cpu().view(torch.int16)))
    got = pools.gpu[:, :, 20:28].cpu().view(torch.int16).numpy()
    np.testing.assert_array_equal(got.view(np.uint16), want_in)


def test_release_event_orders_a_swap_in_behind_a_reader_in_flight(cuda):
    """A read of blocks queued behind a stall on this thread's stream
    (as a replay in flight reads a preempted request's blocks), then the
    blocks are freed (``note_released``) and swapped into: the read sees
    the old bytes, and the swap-in counts as fenced.  Without the release
    record the scatter runs ahead and the read sees the new bytes."""
    pools = _pools(cuda)
    pools.cpu[:, :, 0:4] = 0x3F80                     # 1.0 in bf16
    for release, want_old in ((True, True), (False, False)):
        pools.gpu[:, :, 30:34] = -2.0
        torch.cuda.synchronize()
        torch.cuda._sleep(STALL)
        seen = pools.gpu[:, :, 30:34].clone()         # queued behind it
        if release:
            pools.note_released(30, 4)
        fenced = pools.fenced_swap_ins
        pools.copy_in_staged([0, 1, 2, 3], [(30, 4)])
        torch.cuda.synchronize()
        assert pools.fenced_swap_ins == fenced + int(release)
        assert bool((seen == -2.0).all()) is want_old
        assert bool((pools.gpu[:, :, 30:34] == 1.0).all())


def test_swap_work_during_a_capture_on_another_thread(cuda):
    """While one thread captures a CUDA graph in thread-local mode on a
    side stream, another thread runs a staged swap out and back in: both
    complete, byte-equal, and the graph holds none of it (a replay leaves
    the swapped blocks alone)."""
    pools = _pools(cuda)
    x = torch.ones(1024, device=cuda)
    before = pools.gpu[:, :, 50:54].clone()
    started, swapped = threading.Event(), threading.Event()
    errors = []
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(cuda)

    def capture():
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    y = x * 2
                    started.set()
                    assert swapped.wait(60)
                    y.add_(1)
                finally:
                    graph.capture_end()
        except BaseException as e:            # reported below
            errors.append(e)
            started.set()

    def swap():
        try:
            assert started.wait(60)
            pools.copy_out_staged([(50, 4)], [60, 61, 62, 63])
            pools.gpu[:, :, 50:54] = 0
            torch.cuda.current_stream().synchronize()
            pools.copy_in_staged([60, 61, 62, 63], [(50, 4)])
        except BaseException as e:
            errors.append(e)
        finally:
            swapped.set()
    threads = [threading.Thread(target=capture), threading.Thread(target=swap)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    torch.cuda.synchronize()
    assert torch.equal(_bits(pools.gpu[:, :, 50:54]), _bits(before))
    pools.gpu[:, :, 50:54] = 3.0
    graph.replay()
    torch.cuda.synchronize()
    assert bool((pools.gpu[:, :, 50:54] == 3.0).all())


def test_replays_beside_swaps_from_four_threads_match_a_shadow(cuda):
    """200 decode steps on the main thread over blocks [0, 14) (the page
    bucket grows, so graphs are captured meanwhile), beside four threads
    each making 25 staged swaps (out, then in, over random runs of its
    own 8 device and 32 host blocks), all under one pool lock as the
    engine's.  At the end every swapped block equals the host-side shadow
    of the swaps, and the steps' blocks and tokens equal those of the
    same 200 steps alone."""
    cfg, pools, runner = _runner_setup(cuda, n_cpu=128)
    hist = list(np.random.default_rng(3).integers(1, cfg.vocab_size, 10))
    blocks = list(range(14))
    torch.cuda.synchronize()
    start_pool = pools.gpu.clone()
    lock = threading.Lock()
    shadow_gpu, shadow_cpu, errors = {}, {}, []

    def worker(w):
        try:
            r = np.random.default_rng(10 + w)
            dev = list(range(16 + 8 * w, 24 + 8 * w))
            host = [h for h in range(pools.spec.num_cpu_blocks)
                    if h % 4 == w]
            g = {b: pools.gpu[:, :, b].cpu().clone() for b in dev}
            c = {}
            for i in range(25):
                start = int(r.integers(0, 8))
                n = int(r.integers(1, 9 - start))
                with lock:
                    if i % 2 == 0:
                        cpu = [int(x) for x in r.choice(host, n,
                                                        replace=False)]
                        pools.copy_out_staged([(dev[start], n)], cpu,
                                              after=pools.compute_event())
                        for k in range(n):
                            c[cpu[k]] = g[dev[start + k]]
                    else:
                        n = min(n, len(c))
                        cpu = [int(x) for x in r.choice(list(c), n,
                                                        replace=False)]
                        pools.copy_in_staged(cpu, [(dev[start], n)])
                        for k in range(n):
                            g[dev[start + k]] = c[cpu[k]]
            shadow_gpu.update(g)
            shadow_cpu.update(c)
        except BaseException as e:            # reported below
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for _ in range(200):
        with lock:
            _step(runner, pools, hist, blocks)
    for t in threads:
        t.join(600)
    runner.flush()
    torch.cuda.synchronize()
    assert not errors, errors
    assert runner.stats.steps == 200 and runner.stats.graph_replays > 150
    for b, want in shadow_gpu.items():
        assert torch.equal(_bits(pools.gpu[:, :, b].cpu()), _bits(want)), b
    for h, want in shadow_cpu.items():
        got = torch.from_numpy(pools.cpu[:, :, h].view(np.int16))
        assert torch.equal(_bits(got), _bits(want.view(torch.int16))), h
    # the same steps alone
    stepped = pools.gpu[:, :, :14].clone()
    pools.gpu.copy_(start_pool)
    runner2 = DecodeRunner(runner.mb, block_size=16, trash_block=63)
    hist2 = hist[:10]
    for _ in range(200):
        _step(runner2, pools, hist2, blocks)
    runner2.flush()
    torch.cuda.synchronize()
    assert hist2 == hist
    assert torch.equal(_bits(pools.gpu[:, :, :14]), _bits(stepped))


def test_baselines_on_the_card_give_the_cpus_bytes(cuda):
    """copy_out, copy_in, write_tokens (aligned and per block), and the
    staged pair on the card: host and device pools byte-equal with the
    same calls on CPU pools holding the same bytes."""
    dev = _pools(cuda, seed=4)
    host = PagedPools(dev.spec, device="cpu")
    host.gpu.copy_(dev.gpu.cpu())
    rng = np.random.RandomState(5)
    k = rng.randn(2, 37, 2, 128).astype(np.float32)
    v = rng.randn(2, 37, 2, 128).astype(np.float32)
    kt, vt = torch.from_numpy(k).to(cuda), torch.from_numpy(v).to(cuda)
    for p, kk, vv in ((dev, kt, vt * 0.5), (host, k, v * 0.5)):
        p.write_tokens([7, 3, 9], 0, kk, vv)
        p.write_tokens([7, 3, 9], 35, kk[:, :5], vv[:, :5])
        p.copy_out([9, 9, 2, 40, 3], [5, 6, 7, 8, 9])
        p.copy_in([9, 8, 7, 6, 5], [60, 61, 61, 2, 70])
        p.copy_out_staged([(1, 3), (50, 2)], [20, 21, 22, 23, 24])
        p.copy_in_staged([24, 23, 22, 21, 20], [(80, 5)], stage_blocks=2)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(dev.cpu, host.cpu)
    assert torch.equal(_bits(dev.gpu.cpu()), _bits(host.gpu))
