"""Card tests: tensor-parallel serving with every shard on the one card.
The paged-attention kernel at each shard's local heads (qwen2-1.5b's 6 / 1
of a (1, 2) mesh, olmoe-1b-7b's 4 / 4 of a (1, 4) mesh) against its plain
version, the shards' outputs against the one-device launch; the per-shard
run copies against the one-device copies; and the decode runner's
captured sharded step against the eager sharded step, with the launches
per shard.

Marked ``gpu``; each test skips when ``torch.cuda.is_available()`` is
false (decided in the ``cuda`` fixture, never at import).  Run them on a
machine with an H100 and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_mesh.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke_served import ROOT  # noqa: E402,F401
import chip_smoke  # noqa: E402
from repro_torch.cache.paged import PagedPools, PoolSpec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import decode_runner as dr  # noqa: E402
from repro_torch.core.decode_runner import DecodeRunner  # noqa: E402
from repro_torch.kernels import block_copy as bc  # noqa: E402
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.paged import paged_decode_step_device  # noqa: E402
from test_torch_gpu_graphs import churn_steps  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.parametrize("Hq,Hkv,n", [(12, 2, 2), (16, 16, 4)])
def test_shard_attention_kernels_against_plain(cuda, Hq, Hkv, n):
    """The engine's bucket (B 8 x 64 pages, contexts 256-600) cut into
    head shards: each shard's kernel, on the one-device split-KV plan,
    within chip_smoke's bound of its plain version, the concatenation
    within it of the one-device launch, and one launch per shard."""
    case = chip_smoke.attention_case(8, 64, cuda, seed=1,
                                     ctx_range=(256, 600), Hq=Hq, Hkv=Hkv)
    before = pa.paged_attention.launches
    out = chip_smoke.shard_attention(case, n)
    assert pa.paged_attention.launches - before == n + 1
    assert len(out["max_abs_err_by_shard"]) == n


def test_per_shard_run_copies_are_the_one_device_copies(cuda):
    """The staged gather and scatter over qwen2-1.5b's pool cut into 2
    head shards (each shard's heads flattened into the run copy's block
    rows) move, per shard, the one-device copies' heads, byte for byte,
    with one launch per shard."""
    g = torch.Generator(device=cuda).manual_seed(3)
    full = torch.randn((28, 2, 160, 16, 2, 128), generator=g,
                       device=cuda).bfloat16()
    parts = sharding.shard_tensor(full, sharding.POOL_HEAD_AXIS, 2)
    runs = [(3, 20), (40, 12), (100, 32)]
    before = bc.block_gather_runs.launches
    slab, _ = ops.gather_swap_runs(full, runs)
    slabs, _ = ops.gather_swap_runs(parts, runs)
    assert bc.block_gather_runs.launches - before == 3
    assert torch.equal(sharding.unshard(slabs, sharding.SLAB_HEAD_AXIS)
                       .view(torch.int16), slab.view(torch.int16))
    back = [torch.zeros_like(p) for p in parts]
    ops.scatter_swap_runs(back, slabs, [(0, 20), (60, 44)])
    want = torch.zeros_like(full)
    ops.scatter_swap_runs(want, slab, [(0, 20), (60, 44)])
    torch.cuda.synchronize()
    assert torch.equal(sharding.unshard(back, sharding.POOL_HEAD_AXIS)
                       .view(torch.int16), want.view(torch.int16))


def _mesh_pools(cfg, mesh, seed: int = 0) -> PagedPools:
    """96 GPU and 8 CPU blocks of 16 tokens filled with N(0, 1/4) bf16,
    the device pool per shard."""
    pools = PagedPools(PoolSpec.from_config(cfg, 96, 8),
                       device=mesh.shards[0], mesh=mesh)
    g = torch.Generator(device=mesh.shards[0]).manual_seed(seed)
    full = torch.randn(pools.gpu_full().shape, generator=g,
                       device=mesh.shards[0]) * 0.5
    for p, part in zip(pools.gpu, sharding.shard_tensor(
            full.bfloat16(), sharding.POOL_HEAD_AXIS, mesh.n_shards)):
        p.copy_(part)
    host = torch.randn(pools.cpu.shape,
                       generator=torch.Generator().manual_seed(seed)) * 0.5
    pools.cpu[:] = host.bfloat16().view(torch.int16).numpy().view(np.uint16)
    return pools


@pytest.mark.parametrize("arch,n", [("qwen2-1.5b", 2), ("olmoe-1b-7b", 4)])
def test_sharded_replays_equal_the_eager_sharded_step(cuda, arch, n,
                                                      monkeypatch):
    """The churn run of ``test_torch_gpu_graphs`` (both buckets grow, a
    row is freed and re-registered, blocks are swapped in between two
    replays) at full width cut to 2 layers, on a (1, n) mesh on the card:
    every replay byte-equal to an eager sharded step over clones of its
    state (next tokens, every shard's pool, counters), the one-device
    graph count, and paged attention once per layer per shard per step,
    counted on each shard's pool."""
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    bundle = {"cfg": cfg, "params": T.init_params(cfg, seed=0, device=cuda,
                                                  serving=True)}
    mesh = make_serving_mesh((1, n), [cuda] * n)
    pools = _mesh_pools(cfg, mesh)
    runner = DecodeRunner(bundle, block_size=16, trash_block=95, mesh=mesh)
    real = dr._StepGraph.replay
    held = []

    def replay(graph, tensors):
        clones = [chip_smoke._clone(t) for t in tensors]
        nxt = real(graph, tensors)
        want = paged_decode_step_device(
            runner._params, *clones, cfg=cfg,
            sampled=graph._step.keywords["sampled"])
        outs = (nxt, tensors[0], tensors[2], tensors[3])
        for name, got, ref in zip(("nxt", "pool", "ctx", "tok"), outs, want):
            assert chip_smoke._bytes_equal(got, ref), \
                (name, tuple(tensors[1].shape))
        held.append(tuple(tensors[1].shape))
        return nxt
    monkeypatch.setattr(dr._StepGraph, "replay", replay)
    launches.reset(pa.paged_attention)
    steps = list(churn_steps(runner, pools, cfg.vocab_size))
    runner.flush()
    torch.cuda.synchronize()
    st = runner.stats
    assert len(steps) == st.steps == 48
    assert len(held) == st.graph_replays == 43
    assert runner.graph_cache_size() == st.rebuilds == st.eager_steps == 5
    # (the held replays' eager steps count on their clones' pools)
    per_shard = [launches.on(pa.paged_attention, p) for p in pools.gpu]
    assert per_shard == [2 * st.steps] * n
    assert runner._graphs[False].launches == {pa.paged_attention: 2 * n}


def test_sharded_prefill_chunk_byte_equal_at_512_tokens(cuda):
    """qwen2-1.5b at full width on (1, 2): a 352-token chunk (padded to
    512) through the sharded chunk forward equals the one-device chunk
    byte for byte, logits and carries (the shards' attention runs as one
    product over all their heads; their own products rounded up to 0.001
    apart there)."""
    from repro_torch.models.sharding import CARRY_HEAD_AXIS, unshard
    cfg = get_config("qwen2-1.5b")
    params = T.init_params(cfg, seed=0, device=cuda, serving=True)
    mesh = make_serving_mesh((1, 2), ["cuda:0"] * 2)
    shards = sharding.shard_params(params, mesh)
    for n in (256, 352):
        toks = [(7 * i + 3) % cfg.vocab_size for i in range(n)]
        one = ops.prefill_chunk(params, toks, None, None, 0, cfg=cfg,
                                block_size=16)
        sh = ops.prefill_chunk(shards, toks, None, None, 0, cfg=cfg,
                               block_size=16, mesh=mesh)
        assert torch.equal(sh[0], one[0]), n
        for i in (1, 2):
            assert torch.equal(unshard(sh[i], CARRY_HEAD_AXIS), one[i]), n
