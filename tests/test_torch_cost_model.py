"""The port's I/O cost model and trace generators: the cases of
``tests/test_cost_model.py``, and the same numbers from both packages."""
from repro_torch.data.priority import PriorityTrace
from repro_torch.data.sharegpt import sample_conversations, trace_stats
from repro_torch.io.cost_model import (A10_PCIE4, IterationCostModel,
                                       dispatch_time_us, exec_time_us,
                                       transfer_time_us)
from torch_threads import one_torch_thread  # noqa: F401

from repro.data import priority as jax_priority
from repro.data import sharegpt as jax_sharegpt
from repro.io import cost_model as jax_cost_model


def test_small_transfers_are_dispatch_bound():
    """Paper Fig. 3: a 128 KB per-block copy is dominated by dispatch."""
    t = transfer_time_us(A10_PCIE4, 128 * 1024, h2d=False)
    d = dispatch_time_us(A10_PCIE4)
    assert d / t > 0.85


def test_large_transfers_amortize_dispatch():
    nbytes = 20 * 128 * 1024                       # a ~20-block group
    t = transfer_time_us(A10_PCIE4, nbytes, h2d=False)
    d = dispatch_time_us(A10_PCIE4)
    assert d / t < 0.65
    # grouped moves the same bytes faster than per-block
    per_block = 20 * transfer_time_us(A10_PCIE4, 128 * 1024, h2d=False)
    assert t < per_block / 3


def test_bandwidth_ramp_monotone():
    xs = [exec_time_us(A10_PCIE4, n, True) / max(n, 1)
          for n in (16 * 1024, 64 * 1024, 320 * 1024, 1 << 20)]
    assert all(a >= b - 1e-12 for a, b in zip(xs, xs[1:]))


def test_iteration_cost_scales():
    m = IterationCostModel(A10_PCIE4, model_params=8e9,
                           kv_bytes_per_token=131072)
    t1 = m.decode_iter_us(1, 1000)
    t2 = m.decode_iter_us(64, 64000)
    assert t2 > t1
    assert m.prefill_us(4096) > m.prefill_us(128)
    assert m.decode_iter_us(0, 0) == 0.0


def test_sharegpt_stats_match_paper_shape():
    convs = sample_conversations(500, seed=0)
    s = trace_stats(convs)
    assert 4.0 < s["mean_turns"] < 7.0              # paper: 5.5
    assert 0.7 < s["multi_turn_frac"] < 0.86        # paper: 78%
    # Poisson arrivals at ~1 req/s
    arr = [c.arrival_s for c in convs]
    rate = len(arr) / (arr[-1] - arr[0])
    assert 0.8 < rate < 1.25


def test_priority_trace_reproducible():
    t1 = PriorityTrace("markov", 0.05, seed=3)
    t2 = PriorityTrace("markov", 0.05, seed=3)
    ids = list(range(20))
    for _ in range(200):
        t1.step(ids, ids[:4])
        t2.step(ids, ids[:4])
    assert all(t1.priority(i) == t2.priority(i) for i in ids)


def test_same_numbers_as_reference():
    """Transfer, dispatch and iteration times, sampled conversations and
    a priority trace's walk: equal to the reference's, number for
    number."""
    from repro_torch.io import cost_model
    for hw in ("A10_PCIE4", "TPU_V5E_HOST"):
        ours, ref = getattr(cost_model, hw), getattr(jax_cost_model, hw)
        assert dispatch_time_us(ours) == jax_cost_model.dispatch_time_us(ref)
        for n in (1, 4096, 128 * 1024, 20 * 128 * 1024, 1 << 26):
            for h2d in (False, True):
                assert transfer_time_us(ours, n, h2d=h2d) == \
                    jax_cost_model.transfer_time_us(ref, n, h2d=h2d)
                assert exec_time_us(ours, n, h2d) == \
                    jax_cost_model.exec_time_us(ref, n, h2d)
        m = IterationCostModel(ours, model_params=8e9,
                               kv_bytes_per_token=131072)
        r = jax_cost_model.IterationCostModel(ref, model_params=8e9,
                                              kv_bytes_per_token=131072)
        for b, ctx in ((0, 0), (1, 1000), (64, 64000), (7, 333)):
            assert m.decode_iter_us(b, ctx) == r.decode_iter_us(b, ctx)
        for n in (1, 128, 4096):
            assert m.prefill_us(n) == r.prefill_us(n)
    ours = sample_conversations(200, seed=4)
    ref = jax_sharegpt.sample_conversations(200, seed=4)
    assert [(c.conv_id, c.arrival_s, c.think_time_s,
             [(t.prompt_tokens, t.response_tokens) for t in c.turns])
            for c in ours] == \
        [(c.conv_id, c.arrival_s, c.think_time_s,
          [(t.prompt_tokens, t.response_tokens) for t in c.turns])
         for c in ref]
    assert trace_stats(ours) == jax_sharegpt.trace_stats(ref)
    for pattern in ("markov", "random"):
        t1 = PriorityTrace(pattern, 0.05, seed=3)
        t2 = jax_priority.PriorityTrace(pattern, 0.05, seed=3)
        ids = list(range(20))
        for _ in range(200):
            assert t1.step(ids, ids[:4]) == t2.step(ids, ids[:4])
        assert [t1.priority(i) for i in ids] == [t2.priority(i) for i in ids]
