"""The port's captured decode step on the CPU (its interpret mode).

  * the RoPE tables computed once per step and applied per layer give the
    bits of the per-call ``apply_rope`` they replace, and match the
    reference's ``apply_rope``;
  * the runner makes one step variant per (batch, pages) bucket, as many
    as the reference's jitted step compiles for the same requests, and
    gives the reference's tokens;
  * the bucket's tensors keep their addresses across row churn, a replay
    over a moved pool raises, and the launch counts of a captured graph
    are added at each replay;
  * with sampled rows mixed in, a bucket gets a second (sampled) variant
    at its first sampled step, the variant count still equals the
    reference's jit cache, and the greedy rows give the tokens of an
    all-greedy run.

The churn run (``churn_steps``) is the card tests' own, from
tests/test_torch_gpu_graphs.py.
"""
import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.decode_runner import DecodeRequestView as JaxView
from repro.core.decode_runner import DecodeRunner as JaxDecodeRunner
from repro.models import layers as jax_L
from repro.models import transformer as jax_T
from repro_torch.configs import get_smoke_config
from repro_torch.core import decode_runner as dr
from repro_torch.core.decode_runner import DecodeRequestView, DecodeRunner
from repro_torch.kernels import launches
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from test_torch_gpu_graphs import churn_pools, churn_steps, mixed_churn
from torch_threads import one_torch_thread  # noqa: E402,F401

# the bound of tests/test_torch_model.py on bf16 K/V against the reference
# (XLA keeps fused bf16 intermediates in fp32): per element and on the mean
KV_TOL, MEAN_TOL = 5e-2, 5e-3


def _apply_rope_per_call(x, positions, theta):
    """``layers.apply_rope`` as it was before its tables were split out:
    the frequencies, angles, cos and sin rebuilt at every call."""
    freqs = L.rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs
    if x.dim() == angles.dim() + 1:
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@pytest.mark.parametrize("shape", [(7, 3, 64), (2, 5, 4, 128), (6, 32)],
                         ids=["T_H_D", "B_T_H_D", "T_D"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_rope_tables_give_the_per_call_rope_bits(shape, dtype):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    T_len = shape[-3] if len(shape) >= 3 else shape[0]
    lead = shape[:-3] if len(shape) >= 3 else ()
    pos = rng.integers(0, 4096, lead + (T_len,))
    xt, pt = torch.from_numpy(x).to(dtype), torch.from_numpy(pos)
    want = _apply_rope_per_call(xt, pt, 1e6)
    cos, sin = L.rope_tables(pt, shape[-1], 1e6)
    bits = lambda t: t.contiguous().view(torch.uint8)
    assert torch.equal(bits(L.rope_apply(xt, cos, sin)), bits(want))
    assert torch.equal(bits(L.apply_rope(xt, pt, 1e6)), bits(want))
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    ref = np.asarray(jax_L.apply_rope(jnp.asarray(x, jdtype[dtype]),
                                      jnp.asarray(pos), 1e6), np.float32)
    got = want.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, ref, atol=KV_TOL, rtol=0)
        assert float(np.mean(np.abs(got - ref))) < MEAN_TOL


# ---------------------------------------------------------------------------
# the runner: one variant per bucket, as the reference's jit
# ---------------------------------------------------------------------------

BS = 4


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config("qwen2-1.5b")
    jparams = jax_T.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = T.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    return ({"cfg": jcfg, "params": jparams},
            {"cfg": get_smoke_config("qwen2-1.5b"), "params": tparams})


def test_bucket_variants_match_the_reference_jit(models):
    """tests/test_decode_runner.py's bucket-growth run through both
    runners: the same tokens, and as many step variants in the port as
    compiled variants in the reference, one per bucket rebuild, at most
    log2(max pages) + 1."""
    jb, tb = models
    cfg = jb["cfg"]
    nb, n_steps = 11, 22           # pages 1..6 -> buckets 1, 2, 4, 8
    shape = (cfg.n_layers, 2, nb, BS, cfg.n_kv_heads, cfg.resolved_head_dim)
    jrunner = JaxDecodeRunner(jb, block_size=BS, trash_block=nb - 1)
    trunner = DecodeRunner(tb, block_size=BS, trash_block=nb - 1)
    jpool = jnp.zeros(shape, jnp.bfloat16)
    tpool = torch.zeros(shape, dtype=torch.bfloat16)
    c0 = JaxDecodeRunner.jit_cache_size()
    jhist, thist = [7], [7]
    for ctx in range(n_steps):
        blocks = list(range(ctx // BS + 1))
        jpool = jrunner.decode([JaxView(0, blocks, jhist)], jpool)
        tpool = trunner.decode([DecodeRequestView(0, blocks, thist)], tpool)
    jrunner.flush()
    trunner.flush()
    assert thist == jhist
    compiles = JaxDecodeRunner.jit_cache_size() - c0
    bound = math.ceil(math.log2((n_steps - 1) // BS + 1)) + 1
    st = trunner.stats
    assert trunner.graph_cache_size() == compiles == st.rebuilds \
        == jrunner.stats.rebuilds <= bound
    assert st.eager_steps == st.rebuilds
    assert st.graph_replays == n_steps - st.rebuilds
    assert st.rows_updated < n_steps


def test_churn_keeps_the_bucket_tensors_and_counts_variants(models):
    """Across row churn (a free, a swap-in, a re-register) inside one
    bucket the runner writes the bucket's tensors in place: the active
    mask, block table, contexts and tokens keep their addresses."""
    _, tb = models
    cfg = tb["cfg"]
    pools = churn_pools(cfg, "cpu")
    runner = DecodeRunner(tb, block_size=16, trash_block=95)
    names = ("_active", "_bt", "_ctx", "_tok")
    kept = None
    masks = {}
    for step in churn_steps(runner, pools, cfg.vocab_size):
        if step == 20:
            kept = {n: (getattr(runner, n), getattr(runner, n).data_ptr())
                    for n in names}
        if 20 <= step < 34:
            for n, (t, ptr) in kept.items():
                assert getattr(runner, n) is t and t.data_ptr() == ptr, n
            masks[step] = runner._active.tolist()
    assert masks[25] != masks[26] != masks[30]      # the mask did change
    assert sum(masks[26]) == 3 and sum(masks[30]) == 4
    st = runner.stats
    assert (runner.batch_bucket, runner._pages_bucket) == (8, 8)
    assert runner.graph_cache_size() == st.rebuilds == st.eager_steps == 5
    assert st.graph_replays == st.steps - 5 == 43
    assert runner.invariant_report([0, 1, 2, 3, 4]) == []


def test_replay_over_a_rebound_pool_raises(models):
    _, tb = models
    cfg = tb["cfg"]
    shape = (cfg.n_layers, 2, 8, BS, cfg.n_kv_heads, cfg.resolved_head_dim)
    pool = torch.zeros(shape, dtype=torch.bfloat16)
    runner = DecodeRunner(tb, block_size=BS, trash_block=7)
    hist = [3]
    for _ in range(2):           # an eager step, then a replay
        pool = runner.decode([DecodeRequestView(0, [0], hist)], pool)
    assert runner.stats.graph_replays == 1
    with pytest.raises(RuntimeError, match="pool"):
        runner.decode([DecodeRequestView(0, [0], hist)], pool.clone())
    assert runner.stats.graph_replays == 1


def test_captured_launches_count_at_each_replay(monkeypatch):
    """A launch recorded while a stream captures goes to the capture's
    tally, not to the count; each replay adds the tally; a launch captured
    outside ``launches.capture()`` raises."""
    def kernel():
        pass
    kernel.launches = 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    launches.count(kernel)
    assert kernel.launches == 1
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with launches.capture() as tally:
        launches.count(kernel)
        launches.count(kernel)
    assert kernel.launches == 1 and tally == collections.Counter(
        {kernel: 2})
    with pytest.raises(RuntimeError, match="uncounted"):
        launches.count(kernel)
    for _ in range(3):
        launches.replayed(tally)
    assert kernel.launches == 7


def test_launch_counts_are_exact_across_threads_and_per_pool(monkeypatch):
    """Sixteen threads (more than the cores) count launches of one kernel
    at once with a short switch interval, half eagerly on one pool (by a
    view of it), half by replays on another: the total is exact, and so is
    each pool's share; ``reset`` clears both."""
    import sys
    import threading

    def kernel():
        pass
    kernel.launches = 0
    pools = [torch.zeros(4, 8), torch.zeros(4, 8)]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    tally = launches.Tally()
    tally[kernel] += 2
    tally.on[(kernel, pools[1].untyped_storage().data_ptr())] += 2
    n_threads, n = 16, 20_000
    go = threading.Barrier(n_threads)

    def work(i):
        go.wait()
        for _ in range(n):
            if i % 2:
                launches.replayed(tally)
            else:
                launches.count(kernel, on=pools[0][1])
    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    half = n_threads // 2 * n
    assert kernel.launches == 3 * half
    assert launches.on(kernel, pools[0]) == half
    assert launches.on(kernel, pools[1]) == 2 * half
    launches.reset(kernel)
    assert kernel.launches == 0 and launches.on(kernel, pools[0]) == 0


def test_cpu_replay_runs_the_step_body_over_the_same_tensors(models):
    """The interpret-mode variant: no graph, a static ``nxt`` it writes in
    place at each replay, and the step tensors in ``STEP_TENSORS`` order."""
    _, tb = models
    cfg = tb["cfg"]
    shape = (cfg.n_layers, 2, 8, BS, cfg.n_kv_heads, cfg.resolved_head_dim)
    pool = torch.zeros(shape, dtype=torch.bfloat16)
    runner = DecodeRunner(tb, block_size=BS, trash_block=7)
    hist = [3]
    pool = runner.decode([DecodeRequestView(0, [0], hist)], pool)
    graph = runner._graphs[False]
    assert graph.graph is None and graph.launches == collections.Counter()
    nxt = graph.nxt
    tensors = runner._step_tensors(pool)
    assert [t.data_ptr() for t in tensors] == list(graph._ptrs)
    assert dict(zip(dr.STEP_TENSORS, tensors))["context_lens"] is runner._ctx
    pool = runner.decode([DecodeRequestView(0, [0], hist)], pool)
    assert runner._graphs[False] is graph and graph.nxt is nxt
    runner.flush()
    assert hist[-1] == int(nxt[0]) and len(hist) == 3


# ---------------------------------------------------------------------------
# sampled rows: a second variant per bucket
# ---------------------------------------------------------------------------


def test_mixed_churn_adds_sampled_variants(models):
    """The churn run with request 1 sampling: bucket (4, 4) steps both
    variants, the other buckets one; the greedy requests' histories equal
    the all-greedy run's, request 1's do not."""
    _, tb = models
    greedy, g_hist, mixed, m_hist, _ = mixed_churn(tb, "cpu")
    st = mixed.stats
    assert (st.graphs_captured, st.sampled_graphs, st.eager_steps) == \
        (3, 3, 6)
    assert st.graph_replays == st.steps - 6 == 42
    assert mixed.graph_cache_size() == greedy.graph_cache_size() \
        == st.rebuilds == 5
    # bucket (4, 4) kept its sampled graph past its argmax-only one (no
    # second sampled capture there); the last bucket stepped sampled only
    assert set(mixed._graphs) == {True}
    assert greedy.stats.sampled_graphs == 0
    assert {r: h for r, h in m_hist.items() if r != 1} == \
        {r: h for r, h in g_hist.items() if r != 1}
    assert m_hist[1] != g_hist[1]


def test_sampled_variants_count_as_the_reference_jit(models):
    """A greedy and a sampled request through both runners over growing
    buckets: as many buckets in the port as compiled variants in the
    reference (a sampled row adds a graph, not a bucket), the greedy
    row's tokens equal, the sampled row's equal or first apart at a
    stated near-tie (tests/test_torch_sampling_engine.py)."""
    from test_torch_sampling_engine import explain_divergence
    jb, tb = models
    cfg = jb["cfg"]
    nb, n_steps = 20, 22
    shape = (cfg.n_layers, 2, nb, BS, cfg.n_kv_heads, cfg.resolved_head_dim)
    jrunner = JaxDecodeRunner(jb, block_size=BS, trash_block=nb - 1, seed=5)
    trunner = DecodeRunner(tb, block_size=BS, trash_block=nb - 1, seed=5)
    jpool = jnp.zeros(shape, jnp.bfloat16)
    tpool = torch.zeros(shape, dtype=torch.bfloat16)
    c0 = JaxDecodeRunner.jit_cache_size()
    smp = (0.8, 0, 0.9)
    jh, th = {0: [7], 1: [11]}, {0: [7], 1: [11]}
    for ctx in range(n_steps):
        rids = [0] if ctx < 3 else [0, 1]
        for runner, View, hist, pool in ((jrunner, JaxView, jh, "j"),
                                         (trunner, DecodeRequestView, th,
                                          "t")):
            views = [View(r, [8 * r + b for b in
                              range((len(hist[r]) - 1) // BS + 1)],
                          hist[r], smp if r == 1 else None) for r in rids]
            if pool == "j":
                jpool = runner.decode(views, jpool)
            else:
                tpool = runner.decode(views, tpool)
    jrunner.flush()
    trunner.flush()
    st = trunner.stats
    assert trunner.graph_cache_size() == \
        JaxDecodeRunner.jit_cache_size() - c0 == st.rebuilds
    assert st.sampled_graphs >= 1 and st.graphs_captured >= 1
    assert st.eager_steps == st.graphs_captured + st.sampled_graphs
    assert th[0] == jh[0]
    if th[1] != jh[1]:
        why = explain_divergence(tb, th[1], jh[1], rid=1, seed=5,
                                 sampling=smp, first_tokens=())
        assert why, (th[1], jh[1])


def test_captures_pause_the_garbage_collector():
    """While any capture runs, the cyclic collector is off (a collection
    there could free a dead runner's graphs, which invalidates the
    capture); nested pauses restore it only when the last one ends."""
    import gc
    assert gc.isenabled()
    with dr._gc_paused():
        assert not gc.isenabled()
        with dr._gc_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    assert gc.isenabled()
    gc.disable()
    try:
        with dr._gc_paused():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
