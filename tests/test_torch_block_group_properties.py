"""Hypothesis property tests for the port's Dynamic Block Group Manager
(``repro_torch.core.block_group``), the cases of
``tests/test_block_group_properties.py``, plus:

  * ``on_release``, which only the port has: the ranges it is handed are
    exactly the ranges returned to the free list, each block once;
  * the same operations through both packages' managers leave the same
    free list, the same groups and the same counters."""
import pytest

pytest.importorskip("hypothesis",
                    reason="dev-only dep; see requirements-dev.txt")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import block_group as jax_block_group  # noqa: E402
from repro_torch.core.block_group import (  # noqa: E402
    DynamicBlockGroupManager, OutOfBlocksError)
from torch_threads import one_torch_thread  # noqa: E402,F401

OPS = st.lists(st.tuples(st.integers(0, 7),
                         st.one_of(st.none(), st.integers(1, 300))),
               min_size=1, max_size=60)


def _apply_ops(mgr, ops, after_op=None):
    """ops: list of (req_id, n_tokens) alloc or (req_id, None) release.
    ``after_op`` is called after each op."""
    live = set()
    for rid, n in ops:
        if n is None:
            if rid in live:
                mgr.release_request(rid)
                live.discard(rid)
        else:
            try:
                mgr.allocate_tokens(rid, n)
                mgr.note_tokens(rid, n)
                live.add(rid)
            except OutOfBlocksError:
                pass
        mgr.check_invariants()
        if after_op is not None:
            after_op()
    return live


@settings(max_examples=200, deadline=None)
@given(OPS, st.integers(1, 64))
def test_no_overlap_no_leak(ops, group_blocks):
    mgr = DynamicBlockGroupManager(128, 16, initial_group_blocks=group_blocks)
    live = _apply_ops(mgr, ops)
    # full accounting: free + owned == capacity
    owned = sum(g.length for st_ in mgr.requests.values() for g in st_.groups)
    assert owned + mgr.free_blocks() == mgr.num_blocks
    # releasing everything returns the pool to one merged group
    for rid in list(live):
        mgr.release_request(rid)
    mgr.check_invariants()
    assert mgr.free_blocks() == mgr.num_blocks
    assert len(mgr.free) == 1, "free list must fully merge"


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 5), st.integers(1, 200)),
                min_size=1, max_size=40))
def test_capacity_covers_tokens(allocs):
    """A request's block capacity always covers its recorded tokens."""
    mgr = DynamicBlockGroupManager(256, 16, initial_group_blocks=60)
    for rid, n in allocs:
        try:
            mgr.allocate_tokens(rid, n)
            mgr.note_tokens(rid, n)
        except OutOfBlocksError:
            continue
        st_ = mgr.requests[rid]
        cap = st_.used_blocks() * mgr.block_size_tokens
        assert cap >= mgr.request_tokens(rid)
        mgr.check_invariants()


@settings(max_examples=100, deadline=None)
@given(st.integers(1, 64), st.integers(1, 500))
def test_block_table_is_consistent(group_blocks, tokens):
    mgr = DynamicBlockGroupManager(512, 16, initial_group_blocks=group_blocks)
    mgr.allocate_tokens(1, tokens)
    mgr.note_tokens(1, tokens)
    ids = mgr.request_block_ids(1)
    assert len(ids) == len(set(ids)), "block table must not repeat blocks"
    need = (tokens + 15) // 16
    assert len(ids) >= need
    runs = mgr.request_runs(1)
    assert sum(n for _, n in runs) == len(ids)
    # runs are maximal: no two adjacent
    for (s1, n1), (s2, n2) in zip(runs, runs[1:]):
        assert s1 + n1 < s2


def test_steal_from_active_group():
    mgr = DynamicBlockGroupManager(64, 16, initial_group_blocks=60)
    mgr.allocate_tokens(1, 16)          # gets a (shrunk) group, uses 1 block
    mgr.note_tokens(1, 16)
    free_before = mgr.free_blocks()
    tail = mgr.requests[1].active.free_tail
    assert tail > 0
    # demand more than the free pool: forces a steal from req 1's tail
    want = free_before + 2
    mgr.allocate_tokens(2, 16 * want)
    mgr.note_tokens(2, 16 * want)
    mgr.check_invariants()
    assert mgr.n_steals >= 1
    assert len(mgr.request_block_ids(2)) == want


def test_vllm_baseline_is_per_block():
    mgr = DynamicBlockGroupManager(64, 16, initial_group_blocks=1)
    mgr.allocate_tokens(1, 16 * 5)
    mgr.note_tokens(1, 16 * 5)
    st_ = mgr.requests[1]
    assert all(g.length == 1 for g in st_.groups)


def test_oom_raises():
    mgr = DynamicBlockGroupManager(4, 16, initial_group_blocks=1)
    mgr.allocate_tokens(1, 16 * 4)
    mgr.note_tokens(1, 64)
    with pytest.raises(OutOfBlocksError):
        mgr.allocate_tokens(2, 16)


def test_merge_restores_contiguity():
    mgr = DynamicBlockGroupManager(100, 16, initial_group_blocks=10)
    for rid in range(5):
        mgr.allocate_tokens(rid, 16 * 10)
        mgr.note_tokens(rid, 160)
    for rid in [1, 3]:
        mgr.release_request(rid)
    mgr.check_invariants()
    for rid in [0, 2, 4]:
        mgr.release_request(rid)
    assert len(mgr.free) == 1 and mgr.free_blocks() == 100


# ---------------------------------------------------------------------------
# the port's on_release hook
# ---------------------------------------------------------------------------


def _free_set(mgr):
    return {b for s, n in mgr.free.items() for b in range(s, s + n)}


@settings(max_examples=200, deadline=None)
@given(OPS, st.integers(1, 64))
def test_on_release_reports_each_freed_range_once(ops, group_blocks):
    """Every range handed to ``on_release`` lies in the pool and holds no
    block that is free at that moment (no block is reported twice, nor
    one that was never taken); after each operation the blocks reported
    are free, and every block that became free was reported.  Allocation
    rollbacks, releases and the final release of everything included."""
    mgr = DynamicBlockGroupManager(128, 16, initial_group_blocks=group_blocks)
    reported = []
    before = [_free_set(mgr)]

    def on_release(start, length):
        assert length > 0 and 0 <= start and start + length <= mgr.num_blocks
        rng = set(range(start, start + length))
        assert not rng & _free_set(mgr), \
            f"range {(start, length)} reported while partly free"
        for s, n in reported:
            assert not rng & set(range(s, s + n)), \
                f"range {(start, length)} overlaps {(s, n)} of the same op"
        reported.append((start, length))

    def after_op():
        now = _free_set(mgr)
        freed = {b for s, n in reported for b in range(s, s + n)}
        assert freed <= now, "a reported block is not on the free list"
        assert now - before[0] <= freed, \
            "a block reached the free list unreported"
        reported.clear()
        before[0] = now

    mgr.on_release = on_release
    live = _apply_ops(mgr, ops, after_op)
    for rid in sorted(live):
        mgr.release_request(rid)
        after_op()
    assert _free_set(mgr) == set(range(mgr.num_blocks))


def test_on_release_sees_a_rollback():
    """An allocation that cannot be placed returns what it took, and
    reports it: the hook sees the taken group come back."""
    mgr = DynamicBlockGroupManager(8, 16, initial_group_blocks=4)
    mgr.allocate_tokens(1, 16 * 4)
    mgr.note_tokens(1, 64)
    seen = []
    mgr.on_release = lambda s, n: seen.append((s, n))
    with pytest.raises(OutOfBlocksError):
        mgr.allocate_tokens(2, 16 * 6)
    assert sum(n for _, n in seen) == 4 and mgr.free_blocks() == 4
    mgr.check_invariants()


# ---------------------------------------------------------------------------
# both packages, the same operations
# ---------------------------------------------------------------------------


def _state(mgr):
    return (dict(mgr.free),
            {r: [(g.start, g.length, g.used, g.owner) for g in s.groups]
             for r, s in mgr.requests.items()},
            dict(mgr._token_counts),
            (mgr.n_splits, mgr.n_merges, mgr.n_steals))


@settings(max_examples=100, deadline=None)
@given(OPS, st.integers(1, 64), st.integers(0, 3))
def test_same_operations_same_state_as_reference(ops, group_blocks, seed):
    """Both managers, fed the same operations (steals draw from the same
    seeded generator), end each operation in the same state; the port's
    manager with ``on_release`` set, which must change nothing."""
    ref = jax_block_group.DynamicBlockGroupManager(
        128, 16, initial_group_blocks=group_blocks, seed=seed)
    port = DynamicBlockGroupManager(128, 16, initial_group_blocks=group_blocks,
                                    seed=seed)
    port.on_release = lambda s, n: None
    live = {"ref": set(), "port": set()}
    for rid, n in ops:
        for name, mgr, oom in (("ref", ref, jax_block_group.OutOfBlocksError),
                               ("port", port, OutOfBlocksError)):
            if n is None:
                if rid in live[name]:
                    mgr.release_request(rid)
                    live[name].discard(rid)
            else:
                try:
                    mgr.allocate_tokens(rid, n)
                    mgr.note_tokens(rid, n)
                    live[name].add(rid)
                except oom:
                    pass
        assert _state(port) == _state(ref)
        assert all(port.request_runs(r) == ref.request_runs(r)
                   for r in live["ref"])
    assert live["port"] == live["ref"]
    assert port._rng.getstate() == ref._rng.getstate()
