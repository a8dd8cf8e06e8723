"""The port's priority scheduler (``repro_torch.core.scheduler``) and
priority traces: the cases of ``tests/test_scheduler.py``, and one
scenario run through both packages."""
from repro_torch.core.scheduler import PriorityScheduler, Request, ReqState
from repro_torch.data.priority import PriorityTrace
from repro_torch.data.sharegpt import Conversation, Turn
from torch_threads import one_torch_thread  # noqa: F401

from repro.core import scheduler as jax_scheduler
from repro.data import priority as jax_priority
from repro.data import sharegpt as jax_sharegpt
from repro_torch.core import scheduler as port_scheduler
from repro_torch.data import priority as port_priority
from repro_torch.data import sharegpt as port_sharegpt


def _req(rid, prompt=100, resp=50, turns=1):
    conv = Conversation(conv_id=rid, arrival_s=0.0,
                        turns=[Turn(prompt, resp)] * turns)
    r = Request(conv=conv)
    r.begin_turn(0.0)
    return r


def test_desired_running_priority_order():
    trace = PriorityTrace("random", update_freq=1.0, seed=0)
    s = PriorityScheduler(trace, max_running=8)
    for i in range(6):
        s.add_request(_req(i))
    # fix priorities directly
    trace._prio = {i: i / 10 for i in range(6)}
    desired = s.desired_running(block_budget_tokens=10_000, block_size=16)
    # highest priority first until budget; all fit here
    assert desired[0] == 5
    assert set(desired) == set(range(6))


def test_budget_limits_admission():
    trace = PriorityTrace("random", update_freq=1.0, seed=0)
    s = PriorityScheduler(trace, max_running=8)
    for i in range(6):
        s.add_request(_req(i, prompt=100))
    trace._prio = {i: i / 10 for i in range(6)}
    # each request needs ~116 tokens; budget of 250 fits exactly 2
    desired = s.desired_running(block_budget_tokens=250, block_size=16)
    assert desired == [5, 4]


def test_classify_rebalance():
    trace = PriorityTrace("random", update_freq=1.0, seed=0)
    s = PriorityScheduler(trace, max_running=8)
    for i in range(4):
        s.add_request(_req(i))
    s.move(0, ReqState.RUNNING)
    s.move(1, ReqState.RUNNING)
    s.move(2, ReqState.SWAPPED)
    # desired: 1 (keep), 2 (swap in), 3 (admit); 0 preempted
    pre, swin, adm = s.classify_rebalance([1, 2, 3])
    assert pre == [0] and swin == [2] and adm == [3]


def test_move_is_exclusive():
    trace = PriorityTrace("random", update_freq=1.0, seed=0)
    s = PriorityScheduler(trace, max_running=8)
    s.add_request(_req(1))
    for dst in (ReqState.RUNNING, ReqState.SWAPPED, ReqState.SWAPPING_IN,
                ReqState.WAITING, ReqState.RUNNING):
        s.move(1, dst)
        queues = [s.waiting, s.running, s.swapped, s.swapping_in]
        assert sum(q.count(1) for q in queues) == 1


def test_victims_lowest_priority_first():
    trace = PriorityTrace("random", update_freq=1.0, seed=0)
    s = PriorityScheduler(trace, max_running=8)
    for i in range(4):
        s.add_request(_req(i))
        s.move(i, ReqState.RUNNING)
    trace._prio = {0: 0.9, 1: 0.2, 2: 0.5, 3: 0.7}
    assert s.victims_for_space(exclude=set()) == [1, 2, 3, 0]
    assert s.victims_for_space(exclude={1}) == [2, 3, 0]


def test_markov_trace_stickiness():
    trace = PriorityTrace("markov", update_freq=1.0, seed=1, stickiness=1.0)
    ids = list(range(10))
    for rid in ids:
        trace.priority(rid)
    updated = trace.step(ids, running_ids=[0, 1])
    assert updated
    # running requests got boosted into [0.5, 1.0]
    assert trace.priority(0) >= 0.5
    assert trace.priority(1) >= 0.5


def test_update_period():
    trace = PriorityTrace("random", update_freq=0.25, seed=1)
    hits = sum(trace.step([1], []) for _ in range(100))
    assert hits == 25


def _storm_decisions(sched_mod, prio_mod, share_mod):
    """A random priority storm over 12 requests on one package's
    scheduler: each step's trace update, desired set, rebalance and
    victim order."""
    trace = prio_mod.PriorityTrace("random", update_freq=0.3, seed=5)
    s = sched_mod.PriorityScheduler(trace, max_running=6)
    for i in range(12):
        conv = share_mod.Conversation(conv_id=i, arrival_s=0.0,
                                      turns=[share_mod.Turn(40 + 13 * i, 20)])
        r = sched_mod.Request(conv=conv)
        r.begin_turn(0.0)
        s.add_request(r)
    log = []
    for step in range(60):
        updated = s.step_trace()
        desired = s.desired_running(block_budget_tokens=700, block_size=16)
        pre, swin, adm = s.classify_rebalance(desired)
        for rid in pre:
            s.move(rid, sched_mod.ReqState.SWAPPED)
        for rid in swin + adm:
            s.move(rid, sched_mod.ReqState.RUNNING)
        log.append((updated, desired, pre, swin, adm,
                    s.victims_for_space(exclude={step % 12}),
                    [round(s.priority(i), 12) for i in range(12)],
                    list(s.waiting), list(s.running), list(s.swapped)))
    return log


def test_storm_decisions_match_reference():
    """The same storm through both packages: every step's decisions and
    priorities are equal."""
    assert _storm_decisions(port_scheduler, port_priority, port_sharegpt) \
        == _storm_decisions(jax_scheduler, jax_priority, jax_sharegpt)
