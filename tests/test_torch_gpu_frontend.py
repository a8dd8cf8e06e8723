"""Card tests of the front-end's threading: replicas that step on threads
of their own while another captures a decode-step graph, a migration
round trip between two replicas, and launch counts made from two threads
at once; on qwen2-1.5b at full width with fewer layers (random weights
from a seed).

Marked ``gpu``; each test skips when ``torch.cuda.is_available()`` is
false (decided in the ``cuda`` fixture, never at import):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_frontend.py
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import EngineConfig, SamplingParams, ServingEngine
from repro_torch.core import decode_runner as dr
from repro_torch.core.decode_runner import DecodeRunner
from repro_torch.data.sharegpt import synth_prompt_ids
from repro_torch.kernels import block_copy as bc
from repro_torch.kernels import launches
from repro_torch.kernels import paged_attention as pa
from repro_torch.models.paged import paged_decode_step_device
from test_torch_gpu_graphs import _bits, _bundle, churn_pools, churn_steps

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _run_threads(timeout: float = 600.0, **targets):
    """Run each target on a thread of its own named by its key, all
    started together; re-raise the first error."""
    errors = []

    def wrap(fn):
        def run():
            try:
                fn()
            except BaseException as e:       # reported below
                errors.append(e)
        return run
    threads = [threading.Thread(target=wrap(fn), name=name)
               for name, fn in targets.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a thread hung"
    if errors:
        raise errors[0]


def test_replicas_step_while_one_captures(cuda, monkeypatch):
    """Replica A runs the churn (five buckets, five captures).  While each
    of A's captures is open, replica B, on another thread, takes two more
    steps of its own churn: eager steps, replays, its own captures, a
    swap into its pool (pinned host memory, a stream synchronise) and the
    eager step each replay is held against.  Every replay of either
    replica equals its eager step byte for byte, and A's tokens equal
    those of the same churn run alone."""
    bundle = _bundle(2, cuda)
    cfg = bundle["cfg"]

    solo = DecodeRunner(bundle, block_size=16, trash_block=95)
    solo_hist = {}
    for _ in churn_steps(solo, churn_pools(cfg, cuda), cfg.vocab_size,
                         histories=solo_hist):
        pass
    solo.flush()

    real_replay = dr._StepGraph.replay
    held = {"a": 0, "b": 0}

    def replay(graph, tensors):
        clones = [t.clone() for t in tensors]
        nxt = real_replay(graph, tensors)
        want = paged_decode_step_device(
            solo._params, *clones, cfg=cfg,
            sampled=graph._step.keywords["sampled"])
        for got, ref in zip((nxt, tensors[0], tensors[2], tensors[3]), want):
            assert torch.equal(_bits(got), _bits(ref))
        held[threading.current_thread().name] += 1
        return nxt
    monkeypatch.setattr(dr._StepGraph, "replay", replay)

    a = DecodeRunner(bundle, block_size=16, trash_block=95)
    capturing, b_stepped, a_done = (threading.Event() for _ in range(3))
    overlapped = []
    real_step = a._steps[False]

    def a_step(*tensors):
        if torch.cuda.is_current_stream_capturing():
            capturing.set()
            assert b_stepped.wait(120), "replica B did not step"
            b_stepped.clear()
            overlapped.append(True)
        return real_step(*tensors)
    a_step.keywords = real_step.keywords
    a._steps[False] = a_step
    a_hist = {}

    def run_a():
        try:
            for _ in churn_steps(a, churn_pools(cfg, cuda), cfg.vocab_size,
                                 histories=a_hist):
                pass
            a.flush()
        finally:
            a_done.set()

    def run_b():
        seed, n = 1, 0
        while not a_done.is_set():
            runner = DecodeRunner(bundle, block_size=16, trash_block=95)
            for _ in churn_steps(runner, churn_pools(cfg, cuda, seed=seed),
                                 cfg.vocab_size, seed=seed):
                if capturing.is_set():
                    n += 1
                    if n == 2:
                        n = 0
                        capturing.clear()
                        b_stepped.set()
                if a_done.is_set():
                    break
            runner.flush()
            seed += 1

    _run_threads(a=run_a, b=run_b)
    assert len(overlapped) == a.stats.graphs_captured == 5
    assert held["a"] == a.stats.graph_replays == 43 and held["b"] > 0
    assert a_hist == solo_hist


def session_kv(eng, handle):
    meta = eng.reuse.export_copy(handle)
    nblk = -(-eng.reuse.valid_tokens(handle) // eng.config.block_size)
    ids = meta["block_ids"][:nblk]
    for f in eng.swap.data_deps(ids):
        f.result()
    return eng.pools.cpu[:, :, np.asarray(ids)].copy()


def test_migration_round_trip_between_replicas_is_byte_exact(cuda):
    """A session parked on replica A, exported, imported into replica B
    and continued there: B installs the bytes A shipped, swaps them in
    through the run scatter kernel, makes the tokens of a session that
    never moved, and parks a reuse copy byte-equal to that session's."""
    bundle = _bundle(4, cuda)
    vocab = bundle["cfg"].vocab_size
    cfg = EngineConfig(mode="real", num_gpu_blocks=64, num_cpu_blocks=256,
                       max_running=4, max_batch=4).with_policy("fastswitch")
    p1, p2 = synth_prompt_ids(21, 0, 40, vocab), synth_prompt_ids(21, 1, 12,
                                                                  vocab)
    samp = SamplingParams(max_tokens=8)

    def drain(eng):
        toks = []
        while eng.has_work():
            toks += [t for o in eng.step() for t in (o.token_ids or [])]
        return toks

    ref = ServingEngine(cfg, model_bundle=bundle, stream_tokens=True)
    h = ref.add_request(p1, samp, retain_kv=True)
    ref_t0 = drain(ref)
    ref.continue_session(h, p2, samp, retain_kv=True)
    ref_t1 = drain(ref)

    a = ServingEngine(cfg, model_bundle=bundle, stream_tokens=True)
    b = ServingEngine(cfg, model_bundle=bundle, stream_tokens=True)
    ha = a.add_request(p1, samp, retain_kv=True)
    assert drain(a) == ref_t0
    payload = a.export_session(ha)
    assert payload["valid_tokens"] > 0
    hb = b.import_session(payload)
    assert np.array_equal(session_kv(b, hb), payload["kv"])
    launches.reset(bc.block_scatter_runs)
    b.continue_session(hb, p2, samp, retain_kv=True)
    assert drain(b) == ref_t1
    assert launches.on(bc.block_scatter_runs, b.pools.gpu) > 0
    assert np.array_equal(session_kv(b, hb), session_kv(ref, h))
    for eng in (ref, a, b):
        eng.shutdown()


def test_launch_counts_stay_exact_under_two_threads(cuda):
    """Two runners step their churn on two threads at once (eager steps,
    captures, replays, a swap into each pool): paged attention is counted
    once per layer per step on each pool and in total, and each pool's
    swap-in scatter once."""
    bundle = _bundle(2, cuda)
    cfg = bundle["cfg"]
    runners = [DecodeRunner(bundle, block_size=16, trash_block=95)
               for _ in range(2)]
    pools = [churn_pools(cfg, cuda, seed=s) for s in range(2)]
    launches.reset(pa.paged_attention, bc.block_scatter_runs)

    def run(i):
        def go():
            for _ in churn_steps(runners[i], pools[i], cfg.vocab_size,
                                 seed=i):
                pass
            runners[i].flush()
        return go
    _run_threads(r0=run(0), r1=run(1))
    torch.cuda.synchronize()
    for r, p in zip(runners, pools):
        assert r.stats.steps == 48 and r.stats.graph_replays == 43
        assert launches.on(pa.paged_attention, p.gpu) == 2 * 48
        assert launches.on(bc.block_scatter_runs, p.gpu) == 1
    assert pa.paged_attention.launches == 2 * 2 * 48
    assert bc.block_scatter_runs.launches == 2
