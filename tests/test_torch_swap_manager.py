"""The port's Multithreading Swap Manager — Algorithm 1 semantics and
its timing model: the cases of ``tests/test_swap_manager.py``, and one
dispatch sequence run through both packages."""
from repro_torch.core.swap_manager import MultithreadingSwapManager, SimClock
from repro_torch.io.cost_model import (TPU_V5E_HOST, dispatch_time_us,
                                       exec_time_us)
from torch_threads import one_torch_thread  # noqa: F401

from repro.core import swap_manager as jax_swap_manager
from repro.io import cost_model as jax_cost_model


def _mgr(**kw):
    return MultithreadingSwapManager(TPU_V5E_HOST, None, **kw)


BB = 128 * 1024   # block bytes


def test_sync_dispatch_stalls_clock():
    m = _mgr(async_enabled=False)
    clock = SimClock()
    runs = [(0, 1)] * 10
    m.dispatch(clock, 1, "out", runs, BB, range(10), asynchronous=False)
    expect = 10 * dispatch_time_us(TPU_V5E_HOST) + \
        10 * exec_time_us(TPU_V5E_HOST, BB, h2d=False)
    assert clock.now_us >= expect
    assert m.total_stall_us >= expect


def test_async_dispatch_does_not_stall():
    m = _mgr()
    clock = SimClock()
    t = m.dispatch(clock, 1, "in", [(0, 10)], BB, range(10),
                   asynchronous=True)
    assert clock.now_us == 0.0
    assert t.done_at > 0
    assert m.ongoing_swap_in == [t]
    # not completed before its done_at
    assert m.poll_completed(clock) == []
    clock.advance_to(t.done_at)
    assert m.poll_completed(clock) == [t]
    assert m.ongoing_swap_in == []


def test_grouped_fewer_ops_is_faster():
    hw = TPU_V5E_HOST
    m1, m2 = _mgr(), _mgr()
    c1, c2 = SimClock(), SimClock()
    # same 64 blocks: per-block vs one run
    m1.dispatch(c1, 1, "out", [(i, 1) for i in range(64)], BB, range(64),
                asynchronous=False)
    m2.dispatch(c2, 1, "out", [(0, 64)], BB, range(64), asynchronous=False)
    assert c2.now_us < c1.now_us
    # dispatch overhead dominates the per-block path
    assert c1.now_us - c2.now_us > 0.5 * 63 * dispatch_time_us(hw)


def test_conflict_detection_and_sync():
    m = _mgr()
    clock = SimClock()
    t = m.dispatch(clock, 1, "in", [(5, 10)], BB, range(5, 15),
                   asynchronous=True)
    assert m.detect_conflicts([20, 21]) == []
    assert m.detect_conflicts([14]) == [t]
    n = m.resolve_conflicts(clock, [14, 99])
    assert n == 1
    assert clock.now_us >= t.done_at        # synchronized
    assert m.ongoing_swap_in == []
    assert m.n_conflicts == 1


def test_stream_serialization():
    """Two async swaps share the I/O stream: the second queues behind."""
    m = _mgr()
    clock = SimClock()
    t1 = m.dispatch(clock, 1, "in", [(0, 32)], BB, range(32),
                    asynchronous=True)
    t2 = m.dispatch(clock, 2, "in", [(32, 32)], BB, range(32, 64),
                    asynchronous=True)
    assert t2.done_at > t1.done_at
    assert t2.done_at - t1.done_at >= exec_time_us(
        TPU_V5E_HOST, 32 * BB, h2d=True) * 0.9


def test_adaptive_decision():
    m = _mgr(adaptive=True)
    clock = SimClock()
    # seed r_info with small swaps
    for i in range(20):
        m.dispatch(clock, i, "out", [(i, 1)], BB, [i], asynchronous=True)
    # small pending swap + big batch -> sync preferred
    assert m.decide_async(running_batch=64, pending_swap_blocks=1) is False
    # large pending swap -> async
    assert m.decide_async(running_batch=64, pending_swap_blocks=100) is True
    # async disabled entirely
    m2 = _mgr(async_enabled=False)
    assert m2.decide_async(1, 1000) is False


def test_r_info_records_issue_time():
    """SwapRecord.t_us must be the issue time: a synchronous dispatch
    stalls the clock to done_at before the record is appended, and the
    adaptive profiler needs issue-time ordering."""
    m = _mgr(async_enabled=False)
    clock = SimClock()
    t = m.dispatch(clock, 1, "out", [(0, 8)], BB, range(8),
                   asynchronous=False)
    assert clock.now_us >= t.done_at           # sync stall happened
    assert m.r_info[-1].t_us == t.issued_at == 0.0
    # a later swap records its own (post-stall) issue time
    t2 = m.dispatch(clock, 2, "out", [(8, 8)], BB, range(8, 16),
                    asynchronous=False)
    assert m.r_info[-1].t_us == t2.issued_at == t.done_at


def test_r_info_window_bounded():
    m = _mgr(r_info_window=8)
    clock = SimClock()
    for i in range(30):
        m.dispatch(clock, i, "out", [(0, 1)], BB, [0], asynchronous=True)
    assert len(m.r_info) <= 8


def _dispatch_sequence(mod, hw):
    """Sync and async swaps of mixed granularity, conflicts, polls and
    adaptive decisions on one package's manager; returns what it saw."""
    m = mod.MultithreadingSwapManager(hw, None, adaptive=True)
    clock = mod.SimClock()
    seen = []
    for i in range(40):
        runs = [(j * 3, 1 + (i + j) % 5) for j in range(1 + i % 4)]
        blocks = [b for s, n in runs for b in range(s, s + n)]
        asynchronous = m.decide_async(running_batch=1 + i % 9,
                                      pending_swap_blocks=len(blocks))
        t = m.dispatch(clock, i % 7, "in" if i % 3 else "out", runs, BB,
                       blocks, asynchronous=asynchronous)
        seen.append((asynchronous, t.issued_at, t.done_at, t.n_ops,
                     t.n_blocks, t.bytes_total))
        if i % 5 == 0:
            seen.append(m.resolve_conflicts(clock, [blocks[0], 99]))
        clock.advance(37.5 * (i % 6))
        seen.append([(x.req_id, x.direction)
                     for x in m.poll_completed(clock)])
    seen.append(m.stats())
    seen.append([(r.t_us, r.direction, r.n_ops, r.n_blocks, r.duration_us)
                 for r in m.r_info])
    m.shutdown()
    return seen


def test_dispatch_sequence_matches_reference():
    """The same dispatch sequence on both packages' managers (the TPU and
    the A10 host model): equal tasks, completions, stalls and stats."""
    from repro_torch.core import swap_manager
    from repro_torch.io import cost_model
    for name in ("TPU_V5E_HOST", "A10_PCIE4"):
        assert _dispatch_sequence(swap_manager, getattr(cost_model, name)) \
            == _dispatch_sequence(jax_swap_manager,
                                  getattr(jax_cost_model, name))
