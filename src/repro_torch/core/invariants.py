"""Engine invariant sanitizer — the robustness layer's tripwire
(DESIGN.md §7).

``check_engine_invariants(engine)`` cross-validates the four state
machines that must agree for the engine to be correct — scheduler
queues, GPU block pool, CPU reuse pool, swap-task lists and (real mode)
the decode runner's row maps — and raises a structured
``InvariantViolation`` carrying every violated clause plus a compact
state dump.  It is pure read-only inspection: safe to run every step
(``EngineConfig.check_invariants_every``), in CI chaos smokes, and from
property tests after every mutation.

Why a separate sanitizer when ``DynamicBlockGroupManager`` already has
``check_invariants``?  The allocator can be internally consistent while
the *cross-layer* state is corrupt — a released request still listed in
``running``, a runner row pointing at freed blocks, a swap task pinning
blocks of a dead request.  Containment bugs (this PR's subject) are
exactly cross-layer: a half-torn-down request passes every single-module
check and still leaks.

Invariant catalog (each clause is one numbered check below):
  Q1  queue/state coherence: each rid appears in exactly the queue its
      ``state`` names; queues are disjoint; every queued rid is live.
  B1  pool accounting: free + used group lengths tile [0, num_blocks)
      with no overlap (delegated to the allocator's own check).
  B2  GPU block ownership ⊆ live rids: no blocks held by finished /
      aborted requests.
  B3  token-capacity bounds: each live request's noted tokens fit its
      block capacity; a RUNNING request's ``context_tokens`` never
      exceeds its noted tokens.
  R1  reuse copies: ``valid_tokens <= stored_tokens`` and valid +
      prealloc fits the CPU allocation.
  R2  CPU pool accounting (allocator self-check).
  R3  resident KV: a RUNNING request with no prefill pending holds KV,
      restored or computed, for all of its ``context_tokens - 1``
      positions — no swap-in left positions past its copy's valid
      prefix unwritten (``Request.kv_gap``).
  S1  incomplete ongoing swap-IN tasks' rids are live and SWAPPING_IN
      (sync and retired tasks excluded; the reverse is NOT an invariant:
      a task can complete a poll before its request promotes).
  S2  swap-task GPU block ids are within the pool range.
  D1  runner row maps partition: registered rows ∪ free rows is exactly
      the batch bucket; no row is both.
  D2  registered rows belong to live rids; freed rows point at the
      trash sentinel (empty host mirror).
  P1  prefill carry: every open runner prefill belongs to a live rid
      with ``prefill_remaining > 0``, and vice versa for real mode.
  C1  prefix-cache refcount conservation: every cached block's refcount
      equals the number of live/parked requests mapping it; every
      mapping belongs to a live or parked rid and is a root path.
  C2  prefix-cache block ownership/pinning: every tree node owns exactly
      its one block (single-block group under the node's negative owner
      rid); refcounts exist only on node blocks; no swap task ever
      references a cached (pinned) block.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.scheduler import ReqState


class InvariantViolation(AssertionError):
    """One or more engine invariants failed.  ``violations`` lists every
    failed clause; ``state_dump`` is a compact serializable snapshot for
    postmortems (queue contents, pool counters, task lists)."""

    def __init__(self, violations: List[str], state_dump: Dict):
        self.violations = violations
        self.state_dump = state_dump
        lines = "\n  - ".join(violations)
        super().__init__(
            f"{len(violations)} engine invariant(s) violated:\n  - {lines}\n"
            f"state: {state_dump}")


def _state_dump(eng) -> Dict:
    sched = eng.sched
    return {
        "t_us": eng.clock.now_us,
        "iteration": eng.metrics.iterations,
        "waiting": list(sched.waiting),
        "running": list(sched.running),
        "swapped": list(sched.swapped),
        "swapping_in": list(sched.swapping_in),
        "parked": sorted(eng.parked),
        "gpu_free_blocks": eng.gpu_mgr.free_blocks(),
        "gpu_used_blocks": eng.gpu_mgr.used_blocks(),
        "cpu_free_blocks": eng.reuse.mgr.free_blocks(),
        "ongoing_swap_in": [(t.req_id, t.n_blocks, t.done_at)
                            for t in eng.swap.ongoing_swap_in],
        "ongoing_swap_out": [(t.req_id, t.n_blocks, t.done_at)
                             for t in eng.swap.ongoing_swap_out],
    }


def check_engine_invariants(eng) -> None:
    """Validate the full cross-layer state of a ``ServingEngine``.
    Raises ``InvariantViolation`` listing EVERY failed clause (not just
    the first — a corruption postmortem needs the whole picture)."""
    v: List[str] = []
    sched = eng.sched
    live = set(sched.requests)

    # Q1: queue/state coherence ---------------------------------------
    queues = {ReqState.WAITING: sched.waiting,
              ReqState.RUNNING: sched.running,
              ReqState.SWAPPED: sched.swapped,
              ReqState.SWAPPING_IN: sched.swapping_in}
    seen: Dict[int, str] = {}
    for state, q in queues.items():
        for rid in q:
            if rid in seen:
                v.append(f"Q1: rid {rid} in both {seen[rid]} and "
                         f"{state.value} queues")
            seen[rid] = state.value
            if rid not in live:
                v.append(f"Q1: rid {rid} in {state.value} queue but not "
                         "a live request")
            elif sched.requests[rid].state is not state:
                v.append(f"Q1: rid {rid} in {state.value} queue but "
                         f"state={sched.requests[rid].state.value}")
    for rid, req in sched.requests.items():
        if req.state in queues and rid not in queues[req.state]:
            v.append(f"Q1: live rid {rid} state={req.state.value} missing "
                     "from its queue")

    # B1/B2/B3: GPU pool ----------------------------------------------
    try:
        eng.gpu_mgr.check_invariants()
    except AssertionError as e:
        v.append(f"B1: gpu pool accounting: {e}")
    for rid in list(eng.gpu_mgr.requests):
        # negative rids are engine-internal phantom owners (injected
        # allocation-pressure reserves), not requests
        if rid not in live and rid >= 0:
            v.append(f"B2: gpu blocks held by dead rid {rid}")
    prefix = getattr(eng, "prefix", None)
    for rid in live:
        cap = len(eng.gpu_mgr.request_block_ids(rid)) \
            * eng.config.block_size
        noted = eng.gpu_mgr.request_tokens(rid)
        if noted > cap:
            v.append(f"B3: rid {rid} noted {noted} tokens > block "
                     f"capacity {cap}")
        req = sched.requests[rid]
        # a mapped shared prefix is resident but not noted against the
        # request (its blocks belong to the tree's node owners)
        shared = prefix.shared_tokens(rid) if prefix is not None else 0
        if req.state is ReqState.RUNNING and req.prefill_remaining == 0 \
                and req.context_tokens > noted + shared:
            v.append(f"B3: running rid {rid} context_tokens="
                     f"{req.context_tokens} > noted tokens {noted} + "
                     f"shared {shared}")

    # R1/R2: reuse copies ---------------------------------------------
    try:
        eng.reuse.mgr.check_invariants()
    except AssertionError as e:
        v.append(f"R2: cpu pool accounting: {e}")
    for rid, copy in eng.reuse.copies.items():
        cap = eng.reuse.mgr.request_tokens(rid)
        if copy.valid_tokens > copy.stored_tokens:
            v.append(f"R1: rid {rid} reuse valid {copy.valid_tokens} > "
                     f"stored {copy.stored_tokens}")
        # a GPU-pinned shared prefix keeps valid_tokens at its floor even
        # when the phantom CPU blocks below it were contaminated away
        # (they are never read — see reuse.record_swap_out floor_tokens)
        floor = prefix.shared_tokens(rid) if prefix is not None else 0
        if copy.valid_tokens + copy.prealloc_tokens > cap \
                and copy.valid_tokens > floor:
            v.append(f"R1: rid {rid} reuse valid {copy.valid_tokens} + "
                     f"prealloc {copy.prealloc_tokens} > cpu capacity "
                     f"{cap}")

    # R3: resident KV ---------------------------------------------------
    for rid in live:
        req = sched.requests[rid]
        if req.state is ReqState.RUNNING and req.prefill_remaining == 0 \
                and req.kv_gap is not None:
            lo, hi = req.kv_gap
            v.append(f"R3: running rid {rid} holds no KV for positions "
                     f"[{lo}, {hi}): its swap-in restored them from a copy "
                     f"valid to {lo}")

    # S1/S2: swap tasks ------------------------------------------------
    n_pool = eng.config.num_gpu_blocks
    swapping = set(sched.swapping_in)
    for t in eng.swap.ongoing_swap_in:
        if not t.is_completed(eng.clock.now_us) and not t.failed:
            if t.req_id not in live:
                v.append(f"S1: in-flight swap-in task for dead rid "
                         f"{t.req_id}")
            elif t.req_id not in swapping:
                v.append(f"S1: in-flight swap-in task for rid {t.req_id} "
                         f"not in SWAPPING_IN (state="
                         f"{sched.requests[t.req_id].state.value})")
    for t in eng.swap.ongoing_swap_in + eng.swap.ongoing_swap_out:
        bad = [b for b in t.gpu_blocks if not 0 <= b < n_pool]
        if bad:
            v.append(f"S2: swap task (rid {t.req_id}, {t.direction}) "
                     f"references out-of-pool gpu blocks {bad}")

    # C1/C2: prefix-cache refcounts / ownership / pinning -------------
    if prefix is not None:
        node_blocks = set()
        for node in prefix.iter_nodes():
            node_blocks.add(node.block)
            # every node owns exactly its one block: a single-block group
            # registered under the node's negative owner rid
            groups = eng.gpu_mgr.requests.get(node.owner)
            if groups is None or len(groups.groups) != 1:
                v.append(f"C2: prefix node owner {node.owner} holds "
                         f"{0 if groups is None else len(groups.groups)} "
                         "groups (want exactly 1)")
            else:
                g = groups.groups[0]
                if (g.start, g.length, g.used) != (node.block, 1, 1):
                    v.append(f"C2: prefix node owner {node.owner} group "
                             f"(start={g.start}, len={g.length}, "
                             f"used={g.used}) != block {node.block}")
        # refcount conservation: each cached block's refcount equals the
        # number of live/parked requests mapping it
        mapper_counts: Dict[int, int] = {}
        for rid, path in prefix.mappings().items():
            if rid not in live and rid not in eng.parked:
                v.append(f"C1: prefix mapping held by dead rid {rid}")
            prev = None
            for node in path:
                if node.parent is not prev:
                    v.append(f"C1: rid {rid} mapping is not a root path "
                             f"at block {node.block}")
                prev = node
                mapper_counts[node.block] = \
                    mapper_counts.get(node.block, 0) + 1
        for b in node_blocks | set(mapper_counts):
            have = eng.gpu_mgr.block_refcount(b)
            want = mapper_counts.get(b, 0)
            if have != want:
                v.append(f"C1: block {b} refcount {have} != mapper "
                         f"count {want}")
        for b in list(getattr(eng.gpu_mgr, "_block_refs", {})):
            if b not in node_blocks:
                v.append(f"C1: refcount on non-cached block {b}")
        # pinning: shared blocks never ride a swap task (the engine only
        # swaps the private suffix — this is the tripwire for it)
        for t in eng.swap.ongoing_swap_in + eng.swap.ongoing_swap_out:
            pinned = node_blocks.intersection(t.gpu_blocks)
            if pinned:
                v.append(f"C2: swap task (rid {t.req_id}, {t.direction}) "
                         f"touches pinned cached blocks {sorted(pinned)}")

    # D1/D2 + P1: runner row maps / prefill carry ---------------------
    if eng.runner is not None:
        for msg in eng.runner.invariant_report(live):
            v.append(msg)
        open_prefills = set(eng.runner._prefills)
        carrying = {rid for rid in live
                    if sched.requests[rid].prefill_remaining > 0}
        for rid in open_prefills - live:
            v.append(f"P1: runner prefill carry for dead rid {rid}")
        for rid in carrying - open_prefills:
            v.append(f"P1: rid {rid} has prefill_remaining="
                     f"{sched.requests[rid].prefill_remaining} but no "
                     "runner carry")
    else:
        for rid in live:
            req = sched.requests[rid]
            if req.prefill_remaining > 0 \
                    and req.state is not ReqState.RUNNING:
                v.append(f"P1: rid {rid} prefill_remaining="
                         f"{req.prefill_remaining} in state "
                         f"{req.state.value}")

    if v:
        raise InvariantViolation(v, _state_dump(eng))
