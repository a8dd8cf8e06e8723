"""Card tests: the decode runner's captured CUDA graphs against the eager
step, on qwen2-1.5b at full width (random weights from a seed), for the
argmax-only variant and the sampled one; and the threefry words made on
the card against the CPU's.

Marked ``gpu``; each test skips when ``torch.cuda.is_available()`` is
false (decided in the ``cuda`` fixture, never at import).  Run them on a
machine with an H100 and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_graphs.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.cache.paged import PagedPools, PoolSpec
from repro_torch.configs import get_config
from repro_torch.core import decode_runner as dr
from repro_torch.core.decode_runner import DecodeRequestView, DecodeRunner
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import prng
from repro_torch.models import transformer as T
from repro_torch.models.paged import paged_decode_step_device

pytestmark = pytest.mark.gpu


# the sampled rows of a mixed churn run: request 1 samples, the rest are
# greedy, so bucket (4, 4) steps both variants (request 1 leaves at 26 and
# rejoins at 30)
SAMPLED = {1: (0.8, 50, 0.9)}


def churn_steps(runner, pools, vocab: int, seed: int = 0,
                n_steps: int = 48, sampling=None, histories=None):
    """Drive ``runner`` over ``pools.gpu`` (pages of 16 tokens, >= 80 GPU
    and >= 3 CPU blocks) through a run that grows both buckets, frees a
    row and re-registers it, and swaps blocks into the pool between two
    replays (``pools.copy_in_staged``).  Yields the step index after each
    decode step; ``runner.flush()`` makes the tokens current.

    Plan (request: first block, prompt tokens): 0: (0, 10) from step 0,
    whose 17th token takes the page bucket 1 -> 2 at step 6; 1: (16, 40)
    joins at 10 (batch 2, pages 4); 2: (32, 5) and 3: (48, 20) join at 20
    (batch 4); 1 leaves at 26, blocks are swapped into its pages at 28, it
    rejoins at 30; 4: (64, 70) joins at 34 (batch 8, pages 8).
    ``sampling`` maps a request to its (temperature, top_k, top_p); the
    others decode greedily.  ``histories``, a dict, receives each
    request's token history (the lists the runner appends to)."""
    bs = pools.spec.block_size
    rng = np.random.default_rng(seed)
    plan = {0: (0, 10), 1: (16, 40), 2: (32, 5), 3: (48, 20), 4: (64, 70)}
    hist = {r: [int(t) for t in rng.integers(1, vocab, n + 1)]
            for r, (_, n) in plan.items()}
    if histories is not None:
        histories.update(hist)
    joins = {0: [0], 10: [1], 20: [2, 3], 30: [1], 34: [4]}
    live = []
    for step in range(n_steps):
        live.extend(joins.get(step, []))
        if step == 26:
            live.remove(1)
        if step == 28:
            pools.copy_in_staged([0, 1, 2], [(plan[1][0], 3)])
        runner.flush()
        views = [DecodeRequestView(
            r, list(range(plan[r][0],
                          plan[r][0] + (len(hist[r]) - 1) // bs + 1)),
            hist[r], (sampling or {}).get(r)) for r in live]
        pools.gpu = runner.decode(views, pools.gpu)
        yield step


def churn_pools(cfg, device, seed: int = 0) -> PagedPools:
    """96 GPU and 8 CPU blocks of 16 tokens filled with N(0, 1/4) bf16."""
    pools = PagedPools(PoolSpec.from_config(cfg, 96, 8), device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    pools.gpu.copy_(torch.randn(pools.gpu.shape, generator=g,
                                device=device) * 0.5)
    host = torch.randn(pools.cpu.shape,
                       generator=torch.Generator().manual_seed(seed)) * 0.5
    pools.cpu[:] = host.bfloat16().view(torch.int16).numpy().view(np.uint16)
    return pools


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _bundle(n_layers: int, device):
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=n_layers)
    return {"cfg": cfg, "params": T.init_params(cfg, seed=0, device=device)}


def _bits(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("n_layers", [4, 1])
def test_graph_replays_equal_the_eager_step_byte_for_byte(
        cuda, n_layers, monkeypatch):
    """Every replay of the churn run (48 steps: both buckets grow, a row
    is freed and re-registered, blocks are swapped into the pool between
    two replays) is held against an eager ``paged_decode_step_device``
    over clones of the state it replays over: next tokens, pool, context
    lengths and last tokens equal byte for byte."""
    bundle = _bundle(n_layers, cuda)
    cfg = bundle["cfg"]
    pools = churn_pools(cfg, cuda)
    runner = DecodeRunner(bundle, block_size=16, trash_block=95)
    real = dr._StepGraph.replay
    held = []

    def replay(graph, tensors):
        clones = [t.clone() for t in tensors]
        nxt = real(graph, tensors)
        want = paged_decode_step_device(runner._params, *clones, cfg=cfg)
        outs = (nxt, tensors[0], tensors[2], tensors[3])
        for name, got, ref in zip(("nxt", "pool", "ctx", "tok"), outs, want):
            assert torch.equal(_bits(got), _bits(ref)), \
                (name, tuple(tensors[1].shape))
        held.append(tuple(tensors[1].shape))
        return nxt
    monkeypatch.setattr(dr._StepGraph, "replay", replay)
    steps = list(churn_steps(runner, pools, cfg.vocab_size))
    runner.flush()
    st = runner.stats
    assert len(steps) == st.steps == 48
    assert len(held) == st.graph_replays == 43
    assert set(held) == {(1, 1), (1, 2), (2, 4), (4, 4), (8, 8)}
    assert runner.graph_cache_size() == st.rebuilds == st.eager_steps == 5
    assert isinstance(runner._graphs[False].graph, torch.cuda.CUDAGraph)


def test_launch_counts_count_replays(cuda):
    """The paged-attention count is one per layer per decode step, eager
    or replayed: each replay adds what its graph's capture recorded."""
    bundle = _bundle(2, cuda)
    pools = churn_pools(bundle["cfg"], cuda)
    runner = DecodeRunner(bundle, block_size=16, trash_block=95)
    before = pa.paged_attention.launches
    counts = []
    for _ in churn_steps(runner, pools, bundle["cfg"].vocab_size):
        counts.append(pa.paged_attention.launches - before)
    torch.cuda.synchronize()
    assert counts == [2 * (i + 1) for i in range(48)]
    assert runner.stats.graph_replays == 43
    assert runner._graphs[False].launches == {pa.paged_attention: 2}


def test_replay_over_a_rebound_pool_raises_on_the_card(cuda):
    bundle = _bundle(1, cuda)
    cfg = bundle["cfg"]
    pools = churn_pools(cfg, cuda)
    runner = DecodeRunner(bundle, block_size=16, trash_block=95)
    hist = [3, 5, 7]
    for _ in range(2):
        pools.gpu = runner.decode([DecodeRequestView(0, [0], hist)],
                                  pools.gpu)
    with pytest.raises(RuntimeError, match="pool"):
        runner.decode([DecodeRequestView(0, [0], hist)], pools.gpu.clone())


def _held_replays(runner, cfg, monkeypatch):
    """Hold every replay against an eager step of its own variant over
    clones of the state it replays over; returns the list of (bucket,
    sampled) held, filled as the run goes."""
    real = dr._StepGraph.replay
    held = []

    def replay(graph, tensors):
        clones = [t.clone() for t in tensors]
        nxt = real(graph, tensors)
        sampled = graph._step.keywords["sampled"]
        want = paged_decode_step_device(runner._params, *clones, cfg=cfg,
                                        sampled=sampled)
        outs = (nxt, tensors[0], tensors[2], tensors[3])
        for name, got, ref in zip(("nxt", "pool", "ctx", "tok"), outs, want):
            assert torch.equal(_bits(got), _bits(ref)), \
                (name, tuple(tensors[1].shape), sampled)
        held.append((tuple(tensors[1].shape), sampled))
        return nxt
    monkeypatch.setattr(dr._StepGraph, "replay", replay)
    return held


def mixed_churn(bundle, device, monkeypatch=None):
    """The churn run all greedy, then with ``SAMPLED``: (greedy runner,
    its histories, mixed runner, its histories, the replays held against
    the eager step when ``monkeypatch`` is given)."""
    out = []
    for sampling in (None, SAMPLED):
        pools = churn_pools(bundle["cfg"], device)
        runner = DecodeRunner(bundle, block_size=16, trash_block=95)
        held = (_held_replays(runner, bundle["cfg"], monkeypatch)
                if monkeypatch is not None and sampling else None)
        hists = {}
        for _ in churn_steps(runner, pools, bundle["cfg"].vocab_size,
                             sampling=sampling, histories=hists):
            pass
        runner.flush()
        out += [runner, hists]
    return (*out, held)


@pytest.mark.parametrize("n_layers", [4, 1])
def test_sampled_graph_replays_equal_the_eager_step_byte_for_byte(
        cuda, n_layers, monkeypatch):
    """The churn run with request 1 sampling: every replay of either
    variant equals its eager step byte for byte; bucket (4, 4) keeps both
    variants; the greedy requests' tokens equal the all-greedy run's."""
    bundle = _bundle(n_layers, cuda)
    greedy, g_hist, mixed, m_hist, held = mixed_churn(bundle, cuda,
                                                      monkeypatch)
    st = mixed.stats
    assert len(held) == st.graph_replays == 42
    assert {b for b, smp in held if smp} == {(2, 4), (4, 4), (8, 8)}
    assert {b for b, smp in held if not smp} == {(1, 1), (1, 2), (4, 4)}
    assert (st.graphs_captured, st.sampled_graphs, st.eager_steps) == \
        (3, 3, 6)
    assert mixed.graph_cache_size() == st.rebuilds == 5
    assert all(isinstance(g.graph, torch.cuda.CUDAGraph)
               for g in mixed._graphs.values())
    # bucket (4, 4) kept its sampled graph past its argmax-only one (no
    # second sampled capture there); the last bucket stepped sampled only
    assert set(mixed._graphs) == {True}
    assert {r: h for r, h in m_hist.items() if r != 1} == \
        {r: h for r, h in g_hist.items() if r != 1}
    assert m_hist[1] != g_hist[1]


def test_threefry_words_on_the_card_equal_the_cpus(cuda):
    """Keys folded with positions, and a vocabulary's worth of random
    words and uniform floats per row, made on the card, equal the CPU's
    byte for byte."""
    base = prng.prng_key(7)
    keys = torch.stack([prng.fold_in(base, r) for r in (0, 1, 2 ** 31, 9)])
    ctx = torch.tensor([0, 17, 2 ** 31 - 1, 4096], dtype=torch.int32)
    made = {}
    for device in ("cpu", cuda):
        folded = prng.fold_in(keys.to(device), ctx.to(device))
        made[str(device)] = (folded, prng.random_bits(folded, (151936,)),
                             prng.uniform(folded, (151936,), 1.1754944e-38,
                                          1.0))
    for got, ref in zip(made["cuda"], made["cpu"]):
        assert torch.equal(_bits(got.cpu()), _bits(ref))
