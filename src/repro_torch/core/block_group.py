"""Dynamic Block Group Manager — FastSwitch §3.1.

KV cache memory is preallocated as vLLM-style fixed blocks, then managed in
*block groups*: contiguous runs of blocks allocated buddy-style.  Each
request holds an ordered list of groups; the most recently allocated group
is *active* and its unused tail can be split off to serve other requests
(the paper's "steal from a randomly selected request's active group").

The manager exposes exactly what the paper measures:
  * per-request swap ops == number of contiguous groups (vs per-block ops),
  * average swap granularity (blocks per group),
  * split/merge bookkeeping with adjacency merging of free groups.

``group_size_blocks=1`` degenerates to the vLLM per-block baseline policy.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class OutOfBlocksError(Exception):
    """No free GPU blocks; the scheduler must preempt a victim."""


@dataclass
class BlockGroup:
    start: int                 # first block id (contiguous range)
    length: int                # number of blocks
    owner: Optional[int] = None   # request id
    used: int = 0              # blocks holding live KV

    @property
    def end(self) -> int:
        return self.start + self.length

    @property
    def free_tail(self) -> int:
        return self.length - self.used

    def block_ids(self) -> range:
        return range(self.start, self.start + self.used)


@dataclass
class _ReqState:
    groups: List[BlockGroup] = field(default_factory=list)

    @property
    def active(self) -> Optional[BlockGroup]:
        return self.groups[-1] if self.groups else None

    def used_blocks(self) -> int:
        return sum(g.used for g in self.groups)


class DynamicBlockGroupManager:
    """Buddy-style contiguous block-group allocator over a flat block pool."""

    def __init__(self, num_blocks: int, block_size_tokens: int = 16,
                 initial_group_blocks: int = 60, seed: int = 0):
        self.num_blocks = num_blocks
        self.block_size_tokens = block_size_tokens
        self.initial_group_blocks = max(1, initial_group_blocks)
        self._rng = random.Random(seed)
        # free space as {start: length}, kept merged
        self.free: Dict[int, int] = {0: num_blocks}
        self.requests: Dict[int, _ReqState] = {}
        self._token_counts: Dict[int, int] = {}
        # per-block sharer refcounts (prefix cache): a block with a nonzero
        # refcount is mapped into at least one request's block table beyond
        # its owner and must never reach the free list
        self._block_refs: Dict[int, int] = {}
        # counters
        self.n_splits = 0
        self.n_merges = 0
        self.n_steals = 0

    # ------------------------------------------------------------------
    # free-list primitives
    # ------------------------------------------------------------------

    def free_blocks(self) -> int:
        return sum(self.free.values())

    def used_blocks(self) -> int:
        return sum(r.used_blocks() for r in self.requests.values())

    def _take_free(self, want: int) -> Optional[BlockGroup]:
        """Best-fit: smallest free group >= want; else None."""
        best = None
        for start, length in self.free.items():
            if length >= want and (best is None or length < self.free[best]):
                best = start
        if best is None:
            return None
        length = self.free.pop(best)
        if length > want:
            self.free[best + want] = length - want     # split
            self.n_splits += 1
        return BlockGroup(start=best, length=want)

    def _take_largest(self) -> Optional[BlockGroup]:
        if not self.free:
            return None
        start = max(self.free, key=lambda s: self.free[s])
        length = self.free.pop(start)
        return BlockGroup(start=start, length=length)

    def _release(self, start: int, length: int) -> None:
        """Return a contiguous range to the free list, merging neighbours."""
        if length <= 0:
            return
        for b in range(start, start + length):
            assert not self._block_refs.get(b), \
                f"freeing block {b} with refcount {self._block_refs[b]}"
        # merge with successor
        end = start + length
        if end in self.free:
            length += self.free.pop(end)
            self.n_merges += 1
        # merge with predecessor
        for s in list(self.free):
            if s + self.free[s] == start:
                self.free[s] += length
                self.n_merges += 1
                # possibly also merged with successor already handled
                return
        self.free[start] = length

    # ------------------------------------------------------------------
    # allocation API
    # ------------------------------------------------------------------

    def register(self, req_id: int) -> None:
        self.requests.setdefault(req_id, _ReqState())

    def expected_group_blocks(self, req_id: int) -> int:
        """Dynamic sizing: start from the configured initial size, shrink
        with availability (paper: 'dynamically adjusts this size ... taking
        into account the current availability of free KV cache')."""
        avail = self.free_blocks()
        want = self.initial_group_blocks
        if avail < want * 4:                  # pressure: shrink expectation
            want = max(1, avail // 4)
        return max(1, want)

    def allocate_tokens(self, req_id: int, n_tokens: int) -> List[BlockGroup]:
        """Ensure capacity for ``n_tokens`` *additional* tokens.  Returns the
        list of groups that gained blocks (for swap bookkeeping).

        TRANSACTIONAL: on OutOfBlocksError every block acquired during this
        call is returned (partial allocations must never leak — a request
        that cannot be fully placed holds nothing extra)."""
        self.register(req_id)
        n_blocks = self._blocks_for(req_id, n_tokens)
        touched: List[BlockGroup] = []
        acquired: List[BlockGroup] = []            # new groups this call
        used_increments: Dict[int, int] = {}       # id(group) -> blocks taken
        st = self.requests[req_id]
        while n_blocks > 0:
            g = st.active
            if g is not None and g.free_tail > 0:
                take = min(g.free_tail, n_blocks)
                g.used += take
                used_increments[id(g)] = used_increments.get(id(g), 0) + take
                n_blocks -= take
                if g not in touched:
                    touched.append(g)
                continue
            # grab a whole expected-size group when possible (leaves growth
            # room and keeps future swaps coarse), else whatever fits/exists.
            # Per-block policy (vLLM baseline) always takes single blocks.
            if self.initial_group_blocks == 1:
                want = 1
            else:
                want = max(n_blocks, self.expected_group_blocks(req_id))
            ng = (self._take_free(want)
                  or self._take_free(n_blocks)           # exact-fit attempt
                  or self._take_largest()                # partial
                  or self._steal(n_blocks))              # steal a free tail
            if ng is None:
                self._rollback(st, acquired, used_increments)
                raise OutOfBlocksError(
                    f"need {n_blocks} blocks, none free (req {req_id})")
            ng.owner = req_id
            ng.used = 0
            st.groups.append(ng)
            acquired.append(ng)
            touched.append(ng)
        return touched

    def _rollback(self, st: _ReqState, acquired: List[BlockGroup],
                  used_increments: Dict[int, int]) -> None:
        for g in acquired:
            st.groups.remove(g)
            self._release(g.start, g.length)
            used_increments.pop(id(g), None)
        for g in st.groups:
            inc = used_increments.get(id(g))
            if inc:
                g.used -= inc

    def _blocks_for(self, req_id: int, n_tokens: int) -> int:
        """Blocks needed for n_tokens more tokens given current tail slack."""
        st = self.requests[req_id]
        used_tokens = self.request_tokens(req_id)
        cap_tokens = st.used_blocks() * self.block_size_tokens
        slack = cap_tokens - used_tokens
        # NOTE: the manager tracks capacity at block granularity; token-level
        # occupancy is tracked by the engine.  Here n_tokens are *new* tokens
        # beyond current capacity.
        need_tokens = max(0, n_tokens - slack)
        return (need_tokens + self.block_size_tokens - 1) // self.block_size_tokens

    def request_tokens(self, req_id: int) -> int:
        return self._token_counts.get(req_id, 0)

    def note_tokens(self, req_id: int, n_tokens: int) -> None:
        self._token_counts[req_id] = self._token_counts.get(req_id, 0) + n_tokens

    def _steal(self, n_blocks: int) -> Optional[BlockGroup]:
        """Take the unused tail of a randomly selected request's active
        group (paper §3.1)."""
        candidates = [r for r, st in self.requests.items()
                      if st.active is not None and st.active.free_tail > 0]
        if not candidates:
            return None
        victim = self._rng.choice(candidates)
        vg = self.requests[victim].active
        take = min(vg.free_tail, max(n_blocks, 1))
        # split the tail off the victim's active group
        new_start = vg.end - take
        vg.length -= take
        self.n_steals += 1
        return BlockGroup(start=new_start, length=take)

    # ------------------------------------------------------------------
    # freeing / swap bookkeeping
    # ------------------------------------------------------------------

    def release_request(self, req_id: int) -> List[Tuple[int, int]]:
        """Free all groups of a request.  Returns [(start, used_blocks)]
        runs that were live (for swap-out op accounting)."""
        st = self.requests.pop(req_id, None)
        if st is None:
            return []
        runs = [(g.start, g.used) for g in st.groups if g.used > 0]
        for g in st.groups:
            self._release(g.start, g.length)
        self._token_counts.pop(req_id, None)
        return runs

    def request_runs(self, req_id: int) -> List[Tuple[int, int]]:
        """Contiguous (start, n_blocks) runs of LIVE blocks for swapping.
        Adjacent groups merge into one run (that is the whole point)."""
        st = self.requests.get(req_id)
        if st is None:
            return []
        spans = sorted((g.start, g.used) for g in st.groups if g.used > 0)
        runs: List[Tuple[int, int]] = []
        for start, used in spans:
            if runs and runs[-1][0] + runs[-1][1] == start:
                runs[-1] = (runs[-1][0], runs[-1][1] + used)
            else:
                runs.append((start, used))
        return runs

    def request_block_ids(self, req_id: int) -> List[int]:
        """Logical->physical block table (token order)."""
        st = self.requests.get(req_id)
        if st is None:
            return []
        ids: List[int] = []
        for g in st.groups:
            ids.extend(g.block_ids())
        return ids

    def release_tail_group(self, req_id: int) -> Optional[Tuple[int, int]]:
        """Free the *last* (most recently allocated) group of ``req_id``.

        Public tail-release API shared by KV-reuse contamination
        (``reuse._contaminate_one``) and the prefix-cache evictor — the
        suffix of a request's allocation is always the cheapest part to
        sacrifice (FastSwitch §3.3 contaminates tail-first; prefix-cache
        nodes own exactly one single-block group, so their "tail" is the
        whole node).  Returns the freed ``(start, length)`` range, or
        ``None`` when the request holds no groups.  Refuses (returns
        ``None``) if any block in the tail group is still refcounted by a
        sharer.
        """
        st = self.requests.get(req_id)
        if st is None or not st.groups:
            return None
        g = st.groups[-1]
        if any(self._block_refs.get(b) for b in range(g.start, g.end)):
            return None
        st.groups.pop()
        self._release(g.start, g.length)
        self._token_counts[req_id] = max(
            0, self._token_counts.get(req_id, 0)
            - g.length * self.block_size_tokens)
        if not st.groups:
            self.requests.pop(req_id, None)
            self._token_counts.pop(req_id, None)
        return (g.start, g.length)

    # ------------------------------------------------------------------
    # prefix-cache support: per-block refcounts + block donation
    # ------------------------------------------------------------------

    def ref_block(self, block: int) -> None:
        self._block_refs[block] = self._block_refs.get(block, 0) + 1

    def unref_block(self, block: int) -> None:
        n = self._block_refs.get(block, 0) - 1
        assert n >= 0, f"unref of unreferenced block {block}"
        if n:
            self._block_refs[block] = n
        else:
            self._block_refs.pop(block, None)

    def block_refcount(self, block: int) -> int:
        return self._block_refs.get(block, 0)

    def transfer_prefix_blocks(self, req_id: int,
                               owners: List[int]) -> List[int]:
        """Donate the first ``len(owners)`` used blocks of ``req_id``'s
        block table to new single-block groups owned by ``owners[i]``
        (prefix-cache node insertion).  The physical blocks do not move —
        only ownership and token accounting change, so the request's
        composed block table (shared prefix + private suffix) stays
        byte-identical.  Returns the donated physical block ids in token
        order."""
        n_blocks = len(owners)
        st = self.requests.get(req_id)
        assert st is not None, f"transfer from unknown request {req_id}"
        assert sum(g.used for g in st.groups) >= n_blocks, \
            f"request {req_id} holds fewer than {n_blocks} used blocks"
        out: List[int] = []
        while len(out) < n_blocks:
            g = st.groups[0]
            assert g.used > 0, "leading group with no live blocks"
            take = min(n_blocks - len(out), g.used)
            for i in range(take):
                owner = owners[len(out)]
                self.register(owner)
                self.requests[owner].groups.append(
                    BlockGroup(start=g.start + i, length=1,
                               owner=owner, used=1))
                self._token_counts[owner] = (
                    self._token_counts.get(owner, 0)
                    + self.block_size_tokens)
                out.append(g.start + i)
            if take == g.used and g.length == g.used:
                st.groups.pop(0)
            else:
                # keep the (possibly unused) tail of the group with the
                # donating request
                g.start += take
                g.length -= take
                g.used -= take
        self._token_counts[req_id] = max(
            0, self._token_counts.get(req_id, 0)
            - n_blocks * self.block_size_tokens)
        return out

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------

    def granularity_stats(self) -> Dict[str, float]:
        sizes = [g.used for st in self.requests.values()
                 for g in st.groups if g.used > 0]
        if not sizes:
            return {"avg_group_blocks": 0.0, "n_groups": 0}
        return {"avg_group_blocks": sum(sizes) / len(sizes),
                "n_groups": len(sizes)}

    def check_invariants(self) -> None:
        """Paranoid validation used by property tests."""
        claimed = []
        for start, length in self.free.items():
            assert length > 0
            claimed.append((start, start + length, "free"))
        for rid, st in self.requests.items():
            for g in st.groups:
                assert 0 <= g.used <= g.length, (rid, g)
                assert g.owner == rid
                claimed.append((g.start, g.end, f"req{rid}"))
        claimed.sort()
        prev_end = 0
        covered = 0
        for s, e, who in claimed:
            assert s >= prev_end, f"overlap at {s} ({who})"
            prev_end = e
            covered += e - s
        assert covered <= self.num_blocks
        # free list must be merged (no adjacent free ranges)
        starts = sorted(self.free)
        for a, b in zip(starts, starts[1:]):
            assert a + self.free[a] < b, "unmerged adjacent free groups"
        # refcounted blocks must be live (owned + used), never free
        if self._block_refs:
            owned = set()
            for st in self.requests.values():
                for g in st.groups:
                    owned.update(g.block_ids())
            for blk, n in self._block_refs.items():
                assert n > 0, f"zero refcount retained for block {blk}"
                assert blk in owned, f"refcounted block {blk} is not live"
