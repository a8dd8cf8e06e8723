"""repro_torch's tensor-parallel serving (the head-sharded mesh step, the
per-shard KV pool and the per-shard swap plane) against its one-device
path and the JAX reference (CPU).

The port is single-controller, as the reference: one process drives the
mesh's shards.  The reference's tests force 4 host devices; the port's
counterpart is an explicit device list with repeats (``["cpu"] * M``),
so each shard holds its own pool and runs its own kernels at its own
head count.  One test runs the reference's sharded step in a subprocess
with 4 forced host devices.
"""
import dataclasses
import json
import os
import subprocess
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ops as jax_ops
from repro.models import paged as jax_paged
from repro.models import sharding as jax_sharding
from repro.models import transformer as jax_T
from repro_torch.cache.paged import PagedPools, PoolSpec
from repro_torch.configs import get_smoke_config
from repro_torch.core import EngineConfig, FastSwitchEngine, ServingEngine
from repro_torch.core import SamplingParams
from repro_torch.data.priority import PriorityTrace
from repro_torch.data.sharegpt import Conversation, Turn
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (ServingMesh, check_one_device,
                                     make_serving_mesh)
from repro_torch.models import paged
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from test_torch_model import KV_TOL, LOGIT_TOL, assert_close_bf16
from torch_threads import one_torch_thread  # noqa: E402,F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
BS = 16
# a greedy token of a mesh run that differs from the one-device run's is
# accepted only where the dense forward's logits of the two tokens are
# this close (chip_smoke's near-tie rule)
NEAR_TIE = 5e-2


def cpu_mesh(m: int, d: int = 1):
    return make_serving_mesh((d, m), ["cpu"] * (d * m))


def models(arch: str = "qwen2-1.5b", **kw):
    """(reference cfg, reference params, port cfg, port serving params) of
    the arch's smoke config with ``kw`` replaced, the port's converted
    from the reference's."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), **kw)
    jparams = jax_T.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = T.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    tcfg = dataclasses.replace(get_smoke_config(arch), **kw)
    return jcfg, jparams, tcfg, T.serving_params(tparams)


@pytest.fixture(scope="module")
def qwen():                       # 4 q / 2 kv heads: up to 2 shards
    return models()


@pytest.fixture(scope="module")
def qwen4():                      # 4 q / 4 kv heads: up to 4 shards
    return models(n_kv_heads=4)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jnp.asarray(a, jnp.bfloat16)
                                       ).view(np.int16)).view(torch.bfloat16)


# ---------------------------------------------------------------------------
# the mesh, the local config, the parameter slicing
# ---------------------------------------------------------------------------


def test_make_serving_mesh_identity_device_check_and_refusals():
    from repro.launch.mesh import make_serving_mesh as jax_make
    assert make_serving_mesh((1, 1)) is None is jax_make((1, 1))
    for shape in ((1, 64), (2, 32)):
        with pytest.raises(ValueError, match="devices"):
            make_serving_mesh(shape)
        with pytest.raises(ValueError, match="devices"):
            jax_make(shape)
    with pytest.raises(ValueError, match="needs 4 devices, have 3"):
        make_serving_mesh((1, 4), ["cpu"] * 3)
    mesh = cpu_mesh(2)
    assert mesh == ServingMesh((1, 2), (torch.device("cpu"),) * 2)
    assert mesh.n_shards == 2
    assert mesh.distinct_devices() == (torch.device("cpu"),)
    check_one_device(mesh)
    check_one_device(None)
    # a data axis is accepted and adds no work: the model shards are the
    # first data row's devices
    dm = make_serving_mesh((2, 2), ["cpu", "cpu", "cuda:0", "cuda:1"])
    assert dm.shards == (torch.device("cpu"),) * 2 and dm.shape == (2, 2)
    # shards over several devices are refused before any work
    fake = make_serving_mesh((1, 2), ["cuda:0", "cuda:1"])
    with pytest.raises(NotImplementedError, match="2 devices"):
        check_one_device(fake)
    spec = PoolSpec(n_layers=1, n_kv_heads=2, head_dim=8, block_size=4,
                    num_gpu_blocks=4, num_cpu_blocks=4)
    with pytest.raises(NotImplementedError, match="2 devices"):
        PagedPools(spec, mesh=fake)


def test_shard_local_config_divides_heads():
    for arch in ("qwen2-1.5b", "llama3.2-3b", "olmoe-1b-7b"):
        jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
        for n in (1, 2, 3, 4, 8):
            ok = paged.shardable_heads(tcfg, n)
            assert ok == jax_paged.shardable_heads(jcfg, n)
            if not ok:
                with pytest.raises(ValueError, match="divide"):
                    paged.shard_local_config(tcfg, n)
                continue
            assert dataclasses.asdict(paged.shard_local_config(tcfg, n)) \
                == dataclasses.asdict(jax_paged.shard_local_config(jcfg, n))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_param_slicing_follows_serving_pspecs(qwen):
    jcfg, jparams, tcfg, tparams = qwen
    want = jax_sharding.serving_param_pspecs(jparams)
    got = sharding.serving_param_pspecs(tparams)
    paths = [p for p, _ in _leaves(got)]
    assert sorted(paths) == sorted(p for p, _ in _leaves(
        jax.tree.map(lambda _: 0, jparams)))
    for path in paths:
        assert _at(got, path) == tuple(_at(want, path)), path
    for axis, spec in ((sharding.POOL_HEAD_AXIS, jax_sharding.pool_pspec()),
                       (sharding.SLAB_HEAD_AXIS, jax_sharding.slab_pspec()),
                       (sharding.CARRY_HEAD_AXIS,
                        jax_sharding.carry_pspec())):
        assert [i for i, a in enumerate(spec) if a == "model"] == [axis]
    mesh = cpu_mesh(2)
    trees = sharding.shard_params(tparams, mesh)
    assert len(trees) == 2
    n_sharded = 0
    for path, leaf in _leaves(tparams):
        parts = [_at(t, path) for t in trees]
        if _at(got, path):
            n_sharded += 1
            w = leaf.shape[-1] // 2
            for s, p in enumerate(parts):
                assert p.is_contiguous()
                assert torch.equal(p, leaf[..., s * w:(s + 1) * w])
            assert torch.equal(sharding.unshard(parts, leaf.dim() - 1), leaf)
        else:
            # replicated: held once for the one device both shards share
            assert all(p is leaf for p in parts), path
    assert n_sharded == 6           # wq, wk, wv and qwen2's q/k/v biases


# ---------------------------------------------------------------------------
# the sharded decode step and chunk forward
# ---------------------------------------------------------------------------


def _step_inputs(cfg, seed: int, B: int = 4, P: int = 4, nb: int = 24):
    rng = np.random.default_rng(seed)
    pool = (rng.standard_normal((cfg.n_layers, 2, nb, BS, cfg.n_kv_heads,
                                 cfg.resolved_head_dim)) * 0.5
            ).astype(np.float32)
    bt = rng.permutation(nb - 1)[:B * P].reshape(B, P).astype(np.int32)
    bt[3] = nb - 1                                  # freed row -> trash
    return dict(pool=pool, bt=bt, ctx=np.asarray([5, 17, 40, 0], np.int32),
                tok=rng.integers(1, cfg.vocab_size, B).astype(np.int32),
                active=np.asarray([True, True, True, False]))


def _port_step(tcfg, params, x, mesh, sampling, sampled):
    pool = _bf16(x["pool"])
    if mesh is not None:
        pool = sharding.shard_tensor(pool, sharding.POOL_HEAD_AXIS,
                                     mesh.n_shards)
        params = sharding.shard_params(params, mesh)
    keys = torch.stack([torch.tensor([0, 100 + i]) for i in range(4)])
    args = (params, pool, torch.from_numpy(x["bt"]),
            torch.from_numpy(x["ctx"]).clone(),
            torch.from_numpy(x["tok"]).clone(), torch.from_numpy(x["active"]),
            keys, torch.from_numpy(sampling))
    nxt, pool, ctx, tok = paged.paged_decode_step_device(
        *args, cfg=tcfg, sampled=sampled)
    if mesh is not None:
        assert len(pool) == mesh.n_shards
        pool = sharding.unshard(pool, sharding.POOL_HEAD_AXIS)
    return nxt, pool, ctx, tok


@pytest.mark.parametrize("fixture,m", [("qwen", 2), ("qwen4", 4)])
def test_sharded_decode_step_matches_one_device_and_reference(
        fixture, m, request):
    """The (1, M) step over per-shard pools against the port's one-device
    step and the reference's ``paged_decode_step_device``: equal tokens
    and counters, the pool within the model tests' bf16 tolerance; and a
    batch with sampled rows (the concatenated logits, sampled once) equal
    to the one-device step's draws."""
    jcfg, jparams, tcfg, tparams = request.getfixturevalue(fixture)
    x = _step_inputs(tcfg, seed=2)
    greedy = np.zeros((4, 3), np.float32)
    greedy[:, 2] = 1.0
    jn, jpool, jctx, jtok = jax_paged.paged_decode_step_device(
        jparams, jnp.asarray(x["pool"], jnp.bfloat16), jnp.asarray(x["bt"]),
        jnp.asarray(x["ctx"]), jnp.asarray(x["tok"]),
        jnp.asarray(x["active"]), jnp.zeros((4, 2), jnp.uint32),
        jnp.asarray(greedy), cfg=jcfg)
    one = _port_step(tcfg, tparams, x, None, greedy, sampled=False)
    got = _port_step(tcfg, tparams, x, cpu_mesh(m), greedy, sampled=False)
    np.testing.assert_array_equal(got[0].numpy()[:3], one[0].numpy()[:3])
    np.testing.assert_array_equal(got[0].numpy()[:3], np.asarray(jn)[:3])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jctx))
    np.testing.assert_array_equal(got[3].numpy()[:3], np.asarray(jtok)[:3])
    assert_close_bf16(got[1].float().numpy(), one[1].float().numpy(), KV_TOL)
    assert_close_bf16(got[1].float().numpy(), np.asarray(jpool, np.float32),
                      KV_TOL)
    mixed = greedy.copy()
    mixed[1] = (0.8, 5, 0.9)      # top-k + nucleus sampled row
    mixed[2] = (1.3, 0, 0.7)      # nucleus-only sampled row
    one = _port_step(tcfg, tparams, x, None, mixed, sampled=True)
    got = _port_step(tcfg, tparams, x, cpu_mesh(m), mixed, sampled=True)
    np.testing.assert_array_equal(got[0].numpy()[:3], one[0].numpy()[:3])


@pytest.mark.parametrize("splits", [(44,), (16, 16, 12), (5, 16, 16, 7)])
def test_sharded_prefill_chunks_match_one_device_and_reference(qwen4,
                                                               splits):
    """``ops.prefill_chunk(mesh=)`` over per-shard carries against the
    one-device chunk forward and the reference's: last logits and the
    carries (concatenated over shards) within tolerance; each chunk's
    per-shard K/V the one-device chunk's heads."""
    jcfg, jparams, tcfg, tparams = qwen4
    mesh = cpu_mesh(4)
    shards = sharding.shard_params(tparams, mesh)
    toks = np.random.RandomState(0).randint(1, jcfg.vocab_size, 44).tolist()
    jkc = jvc = tkc = tvc = skc = svc = None
    pos = 0
    for n in splits:
        jl, jkc, jvc, _, _ = jax_ops.prefill_chunk(
            jparams, toks[pos:pos + n], jkc, jvc, pos, cfg=jcfg,
            block_size=BS)
        tl, tkc, tvc, tk, _ = ops.prefill_chunk(
            tparams, toks[pos:pos + n], tkc, tvc, pos, cfg=tcfg,
            block_size=BS)
        sl, skc, svc, sk, _ = ops.prefill_chunk(
            shards, toks[pos:pos + n], skc, svc, pos, cfg=tcfg,
            block_size=BS, mesh=mesh)
        pos += n
        assert len(sk) == 4 and sk[0].shape[2] == 1
        assert_close_bf16(sl.numpy(), tl.numpy(), LOGIT_TOL)
        assert_close_bf16(sl.numpy(), jl, LOGIT_TOL)
        assert_close_bf16(sharding.unshard(sk, 2).float().numpy(),
                          tk.float().numpy(), KV_TOL)
    for got, one, want in ((skc, tkc, jkc), (svc, tvc, jvc)):
        full = sharding.unshard(got, sharding.CARRY_HEAD_AXIS)
        assert full.shape == one.shape == want.shape
        assert_close_bf16(full[:, :pos].float().numpy(),
                          one[:, :pos].float().numpy(), KV_TOL)
        assert_close_bf16(full[:, :pos].float().numpy(), want[:, :pos],
                          KV_TOL)


def test_vocab_sharded_greedy_tie_break():
    """Equal maxima planted in two shards: the lowest shard's index wins,
    as one argmax over the full logits gives; a row without a tie takes
    its own maximum.  The products are exact (one nonzero input), so the
    planted logits are equal in every shard's product."""
    V, d, n = 512, 16, 4
    g = torch.Generator().manual_seed(0)
    table = torch.rand((V, d), generator=g) - 0.5
    x = torch.zeros((3, d))
    x[:, 0] = 1.0
    table[:, 0] = torch.round(table[:, 0] * 64) / 64     # exact logits
    table[300, 0] = table[130, 0] = 4.0                   # shards 2 and 1
    table[511, 0] = 4.0                                   # shard 3
    x[2, 0] = -1.0                                        # row 2: the min
    table[7, 0] = -8.0
    got = paged.vocab_sharded_greedy(table, x, n)
    full = torch.argmax(x @ table.T, dim=-1).to(torch.int32)
    assert got.tolist() == full.tolist() == [130, 130, 7]
    # ties inside one shard: the first index there
    table[140, 0] = 4.0
    assert paged.vocab_sharded_greedy(table, x, n).tolist()[0] == 130
    table[130, 0] = 0.0
    assert paged.vocab_sharded_greedy(table, x, n).tolist()[0] == 140


# ---------------------------------------------------------------------------
# the per-shard pool and swap plane
# ---------------------------------------------------------------------------

SPEC = PoolSpec(n_layers=2, n_kv_heads=4, head_dim=16, block_size=16,
                num_gpu_blocks=12, num_cpu_blocks=24)


def _fill(pools: PagedPools, seed: int) -> torch.Tensor:
    """Random finite bf16 over the whole pool (the same full-layout bytes
    for any mesh); returns them."""
    rng = np.random.RandomState(seed)
    s = pools.spec
    full = _bf16(rng.randn(s.n_layers, 2, s.num_gpu_blocks, s.block_size,
                           s.n_kv_heads, s.head_dim).astype(np.float32))
    if pools.mesh is None:
        pools.gpu.copy_(full)
    else:
        for g, part in zip(pools.gpu, sharding.shard_tensor(
                full, sharding.POOL_HEAD_AXIS, pools.n_shards)):
            g.copy_(part)
    return full


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


@pytest.mark.parametrize("m", [1, 2, 4])
def test_per_shard_slab_round_trip_byte_exact(m):
    pools = PagedPools(SPEC, device="cpu",
                       mesh=None if m == 1 else cpu_mesh(m))
    assert pools.n_shards == m
    if m > 1:
        assert [g.shape[4] for g in pools.gpu] == [4 // m] * m
    before = _fill(pools, 7)
    # swap out 5 blocks as 2 chunks: the 2nd a PARTIAL last chunk (3
    # blocks in a 4-block slab bucket)
    pools.copy_out_staged([(1, 2)], [0, 1])
    pools.copy_out_staged([(4, 3)], [2, 3, 4])
    for g, _ in pools._shards():
        g[:, :, 1:3] = 0
        g[:, :, 4:7] = 0
    pools.copy_in_staged([0, 1], [(1, 2)])
    pools.copy_in_staged([2, 3, 4], [(4, 3)])
    np.testing.assert_array_equal(_bytes(pools.gpu_full()), _bytes(before))
    assert (pools.staged_out_calls, pools.staged_in_calls) == (2, 2)
    assert pools.d2h_transfers == m * 2 and pools.h2d_transfers == m * 2
    # a swap-in over the stage size: one staged call per sub-slab, the
    # last one partial, each one h2d per shard
    pools.copy_out_staged([(0, 5)], [10, 11, 12, 13, 14])
    for g, _ in pools._shards():
        g[:, :, 0:5] = 0
    pools.copy_in_staged([10, 11, 12, 13, 14], [(0, 5)], stage_blocks=2)
    np.testing.assert_array_equal(_bytes(pools.gpu_full()), _bytes(before))
    assert pools.staged_in_calls == 5
    assert pools.h2d_transfers == m * pools.staged_in_calls
    assert pools.d2h_transfers == m * pools.staged_out_calls


def test_per_shard_ops_are_the_one_device_ops_head_slices():
    """The per-shard staged gather and scatter (each shard's local heads
    flattened into the run copy's block rows), the prefill insert and the
    carry seed give, per shard, the heads of the one-device results."""
    rng = np.random.RandomState(4)
    full = _bf16(rng.randn(2, 2, 12, BS, 4, 16).astype(np.float32))
    parts = sharding.shard_tensor(full, sharding.POOL_HEAD_AXIS, 4)
    runs = [(1, 3), (7, 2)]
    slab, n = ops.gather_swap_runs(full, runs)
    slabs, n4 = ops.gather_swap_runs(parts, runs)
    assert n == n4 == 5 and len(slabs) == 4
    assert torch.equal(sharding.unshard(slabs, sharding.SLAB_HEAD_AXIS),
                       slab)
    back = torch.zeros_like(full)
    back4 = [torch.zeros_like(p) for p in parts]
    ops.scatter_swap_runs(back, slab, [(0, 2), (5, 3)])
    assert ops.scatter_swap_runs(back4, slabs, [(0, 2), (5, 3)]) is back4
    assert torch.equal(sharding.unshard(back4, sharding.POOL_HEAD_AXIS),
                       back)
    k = _bf16(rng.randn(2, 2 * BS, 4, 16).astype(np.float32))
    v = _bf16(rng.randn(2, 2 * BS, 4, 16).astype(np.float32))
    ops.insert_prefill(full, k, v, [3, 9], BS)
    ops.insert_prefill(parts, sharding.shard_tensor(k, 2, 4),
                       sharding.shard_tensor(v, 2, 4), [3, 9], BS)
    assert torch.equal(sharding.unshard(parts, sharding.POOL_HEAD_AXIS),
                       full)
    kc, vc = ops.seed_prefill_carry(full, [3, 9, 5], 3 * BS, trash=11)
    kc4, vc4 = ops.seed_prefill_carry(parts, [3, 9, 5], 3 * BS, trash=11)
    assert torch.equal(sharding.unshard(kc4, 2), kc)
    assert torch.equal(sharding.unshard(vc4, 2), vc)
    grown = ops._grow_carry(kc4, n_new=8 * BS)
    assert [g.shape for g in grown] == [(2, 8 * BS, 1, 16)] * 4
    assert torch.equal(sharding.unshard(grown, 2),
                       ops._grow_carry(kc, n_new=8 * BS))


def test_cross_mesh_host_bytes_equal():
    """One staged swap-out of the same pool bytes gives the same host
    bytes on every mesh and in the reference's one-device pools; so do the
    baselines (``copy_out``, ``write_tokens`` then ``read_tokens``)."""
    from repro.cache.paged import PagedPools as JaxPools
    from repro.cache.paged import PoolSpec as JaxSpec
    ref = JaxPools(JaxSpec(**dataclasses.asdict(SPEC)))
    full = None
    hosts = []
    for m in (1, 2, 4):
        pools = PagedPools(SPEC, device="cpu",
                           mesh=None if m == 1 else cpu_mesh(m))
        full = _fill(pools, 11)
        pools.copy_out_staged([(2, 3), (8, 2)], [5, 6, 7, 9, 10])
        pools.copy_out([0, 11], [1, 2])
        rng = np.random.RandomState(3)
        k = rng.randn(2, 20, 4, 16).astype(np.float32)
        v = rng.randn(2, 20, 4, 16).astype(np.float32)
        pools.write_tokens([3, 9], 0, k, v)
        rk, rv = pools.read_tokens([3, 9], 20)
        hosts.append((pools.cpu.copy(), _bytes(rk), _bytes(rv),
                      _bytes(pools.gpu_full())))
    ref.gpu = jnp.asarray(np.asarray(full.float()), jnp.bfloat16)
    ref.copy_out_staged([(2, 3), (8, 2)], [5, 6, 7, 9, 10])
    ref.copy_out([0, 11], [1, 2])
    for got in hosts[1:]:
        for a, b in zip(got, hosts[0]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(hosts[0][0], ref.cpu)


# ---------------------------------------------------------------------------
# the engine: sim mode ignores the mesh; real-mode storms on it
# ---------------------------------------------------------------------------


def _sim(pkg, shape):
    """A replay (metrics without wall times, TTFTs, TBTs) and an online
    session (its event log) in sim mode at ``shape``, through ``pkg``'s
    engine: the reference's or the port's."""
    core = __import__(f"{pkg}.core", fromlist=["core"])
    trace_cls = __import__(f"{pkg}.data.priority",
                           fromlist=["priority"]).PriorityTrace
    sharegpt = __import__(f"{pkg}.data.sharegpt", fromlist=["sharegpt"])
    convs = [sharegpt.Conversation(
        conv_id=i, arrival_s=0.05 * i,
        turns=[sharegpt.Turn(40, 30), sharegpt.Turn(20, 20)],
        think_time_s=0.3) for i in range(6)]
    cfg = core.EngineConfig(mode="sim", num_gpu_blocks=32,
                            num_cpu_blocks=256, max_running=3,
                            swap_chunk_blocks=2,
                            mesh_shape=shape).with_policy("fastswitch")
    eng = core.FastSwitchEngine(cfg, convs,
                                trace=trace_cls("random", 0.5, seed=5))
    eng.run(max_iterations=50_000)
    assert eng.done()
    summary = {k: v for k, v in eng.metrics.summary().items()
               if "wall" not in k}
    online = core.ServingEngine(replace(cfg, num_gpu_blocks=48),
                                trace=trace_cls("random", 0.3, seed=5))
    for i in range(8):
        online.add_request(40 + 9 * i,
                           core.SamplingParams(max_tokens=12 + i))
    while online.has_work():
        online.step()
    return (summary, eng.metrics.ttfts_us, eng.metrics.tbts_us,
            [e.as_dict() for e in online.events])


def test_sim_engine_ignores_mesh_shape():
    """Sim mode has no device data plane: any ``mesh_shape`` gives the
    same clocks, metrics and event log, in the port as in the reference
    (``tests/test_mesh_sharding.py::test_sim_engine_ignores_mesh_shape``)."""
    want = _sim("repro", (1, 4))
    assert want[0]["preemptions"] > 0 and want[3]
    assert _sim("repro", (1, 1)) == want
    for shape in ((1, 1), (1, 2), (1, 4), (2, 2)):
        assert _sim("repro_torch", shape) == want


def _count_swaps(eng) -> dict:
    counts = {}
    dispatch = eng.swap.dispatch

    def wrapped(clock, req_id, direction, *a, **k):
        if k.get("copy_fn") is not None:
            counts[(req_id, direction)] = counts.get((req_id, direction),
                                                     0) + 1
        return dispatch(clock, req_id, direction, *a, **k)
    eng.swap.dispatch = wrapped
    return counts


def _storm(tparams, tcfg, m: int, **cfg_kw):
    convs = [Conversation(conv_id=i, arrival_s=0.0,
                          turns=[Turn(40 + 8 * i, 10), Turn(20, 6)],
                          think_time_s=0.2) for i in range(6)]
    cfg = EngineConfig(mode="real", num_gpu_blocks=16, num_cpu_blocks=256,
                       max_running=4, max_batch=4, block_size=BS,
                       swap_chunk_blocks=1, mesh_shape=(1, m),
                       check_invariants_every=1, **cfg_kw
                       ).with_policy("fastswitch")
    cfg = replace(cfg, policy=replace(cfg.policy, chunked_prefill_tokens=32))
    bundle = {"cfg": tcfg, "params": tparams, "mesh_devices": ["cpu"] * m}
    eng = FastSwitchEngine(cfg, convs, trace=PriorityTrace("random", 0.5,
                                                           seed=13),
                           model_bundle=bundle)
    swaps = _count_swaps(eng)
    eng.run(max_iterations=20_000)
    assert eng.done()
    assert eng.metrics.invariant_checks > 0
    return eng, swaps, convs


def near_tie_or_equal(params, cfg, got, want, tol: float = NEAR_TIE):
    """None where the histories are equal; else (index, gap): the first
    difference, where the dense forward's logits of the two tokens must be
    within ``tol``."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            logits, _, _ = T.forward_seq(
                params, cfg, torch.tensor([want[:i]], dtype=torch.long))
            gap = float((logits[0, -1, b] - logits[0, -1, a]).abs())
            assert gap < tol, f"diverge at {i}: gap {gap}"
            return i, gap
    assert len(got) == len(want)
    return None


@pytest.mark.parametrize("fixture,m", [("qwen", 2), ("qwen4", 4)])
def test_real_storm_on_mesh_matches_one_device(fixture, m, request):
    """A real-mode storm under fastswitch with chunked prefill and the
    invariant sanitizer every step: every turn finished, every
    conversation swapped both ways, one host transfer per staged chunk
    per shard, the decode graph counts of the one-device run, and greedy
    tokens equal to it (or a near-tie of the dense forward)."""
    _, _, tcfg, tparams = request.getfixturevalue(fixture)
    one, one_swaps, convs = _storm(tparams, tcfg, 1)
    eng, swaps, _ = _storm(tparams, tcfg, m)
    p = eng.pools
    assert p.n_shards == m and len(p.gpu) == m
    assert p.staged_out_calls > 0 and p.staged_in_calls > 0
    assert p.d2h_transfers == m * p.staged_out_calls
    assert p.h2d_transfers == m * p.staged_in_calls
    assert (p.staged_out_calls, p.staged_in_calls) == \
        (one.pools.staged_out_calls, one.pools.staged_in_calls)
    for c in convs:
        assert swaps.get((c.conv_id, "out"), 0) > 0, c.conv_id
        assert swaps.get((c.conv_id, "in"), 0) > 0, c.conv_id
    assert swaps == one_swaps
    st, st1 = eng.runner.stats, one.runner.stats
    assert (st.rebuilds, st.graphs_captured, st.sampled_graphs,
            st.eager_steps, st.prefill_chunks) == \
        (st1.rebuilds, st1.graphs_captured, st1.sampled_graphs,
         st1.eager_steps, st1.prefill_chunks)
    assert eng.runner.graph_cache_size() == one.runner.graph_cache_size()
    assert eng.metrics.summary()["preemptions"] > 0
    for cid, want in one._token_hist_by_conv.items():
        near_tie_or_equal(tparams, tcfg, eng._token_hist_by_conv[cid], want)


def _prefix_run(tparams, tcfg, m: int):
    """The prefix cache on, two sessions sharing a 32-token system prompt,
    the second sampled: returns the engine and its outputs' tokens."""
    cfg = EngineConfig(mode="real", num_gpu_blocks=32, num_cpu_blocks=128,
                       max_running=4, max_batch=4, block_size=BS,
                       mesh_shape=(1, m), prefix_cache=True,
                       check_invariants_every=1).with_policy("fastswitch")
    bundle = {"cfg": tcfg, "params": tparams, "mesh_devices": ["cpu"] * m}
    eng = ServingEngine(cfg, trace=PriorityTrace("random", 0.3, seed=5),
                        model_bundle=bundle, stream_tokens=True)
    system = list(range(1, 33))
    toks = {}
    for i in range(3):          # each after the one before has finished
        h = eng.add_request(system + [40 + i, 50 + i, 60 + i],
                            SamplingParams(max_tokens=6,
                                           temperature=0.7 * i))
        toks[h] = []
        while eng.has_work():
            for out in eng.step():
                toks[out.handle].extend(out.token_ids or [])
    return eng, toks


def test_prefix_cache_with_sampled_row_on_mesh(qwen):
    _, _, tcfg, tparams = qwen
    one, want = _prefix_run(tparams, tcfg, 1)
    eng, got = _prefix_run(tparams, tcfg, 2)
    assert eng.prefix.stats()["hits"] > 0
    assert eng.prefix.stats() == one.prefix.stats()
    assert eng.runner.stats.sampled_graphs == \
        one.runner.stats.sampled_graphs > 0
    assert got == want


# ---------------------------------------------------------------------------
# the reference's sharded step on 4 forced host devices
# ---------------------------------------------------------------------------

REFERENCE_SHARDED_STEP = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.models import transformer as T
from repro.models.paged import paged_decode_step_device_sharded
cfg, x = sys.argv[1], json.load(open(sys.argv[2]))
from repro.configs import get_smoke_config
import dataclasses
cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), n_kv_heads=4)
assert len(jax.devices()) == 4
params = T.init_params(cfg, jax.random.PRNGKey(0))
mesh = jax.make_mesh((1, 4), ("data", "model"))
pool = np.load(sys.argv[3])
nxt, pool, ctx, tok = paged_decode_step_device_sharded(
    params, jnp.asarray(pool, jnp.bfloat16), jnp.asarray(x["bt"], jnp.int32),
    jnp.asarray(x["ctx"], jnp.int32), jnp.asarray(x["tok"], jnp.int32),
    jnp.asarray(x["active"]), jnp.zeros((4, 2), jnp.uint32),
    jnp.asarray(x["sampling"], jnp.float32), cfg=cfg, mesh=mesh)
np.save(sys.argv[3] + ".out.npy", np.asarray(pool, np.float32))
print(json.dumps({"nxt": np.asarray(nxt).tolist(),
                  "ctx": np.asarray(ctx).tolist(),
                  "tok": np.asarray(tok).tolist()}))
"""


def test_reference_sharded_step_on_forced_devices_matches_port(qwen4,
                                                               tmp_path):
    """The reference's ``paged_decode_step_device_sharded`` on a (1, 4)
    mesh of 4 forced host devices, held to the port's (1, 4) step on the
    same inputs: equal tokens and counters, the pool within tolerance."""
    _, _, tcfg, tparams = qwen4
    x = _step_inputs(tcfg, seed=5)
    greedy = np.zeros((4, 3), np.float32)
    greedy[:, 2] = 1.0
    inputs = tmp_path / "x.json"
    inputs.write_text(json.dumps({k: x[k].tolist() for k in
                                  ("bt", "ctx", "tok", "active")}
                                 | {"sampling": greedy.tolist()}))
    np.save(tmp_path / "pool.npy", x["pool"])
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    r = subprocess.run([sys.executable, "-c", REFERENCE_SHARDED_STEP,
                        "qwen2", str(inputs), str(tmp_path / "pool.npy")],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    nxt, pool, ctx, tok = _port_step(tcfg, tparams, x, cpu_mesh(4), greedy,
                                     sampled=False)
    assert nxt.tolist()[:3] == want["nxt"][:3]
    assert ctx.tolist() == want["ctx"]
    assert tok.tolist()[:3] == want["tok"][:3]
    assert_close_bf16(pool.float().numpy(),
                      np.load(str(tmp_path / "pool.npy") + ".out.npy"),
                      KV_TOL)
