"""KV Cache Reuse Mechanism — FastSwitch §3.3.

Keeps a persistent CPU-side copy of each conversation's KV cache across
preemptions and turns, tracks *contamination* (CPU blocks reclaimed by
higher-priority requests), and computes the minimal swap-out increment.

CPU space is managed by a second DynamicBlockGroupManager so that the next
turn's increment can be *preallocated adjacent* to the existing copy
(paper: "preallocates additional memory space for the next turn's swap out
increment ... improves memory continuity").

Invariant (tested property): a request never reuses a contaminated block —
``valid_tokens`` only counts the uncontaminated *prefix* of the copy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.block_group import DynamicBlockGroupManager, OutOfBlocksError


@dataclass
class CpuCopy:
    valid_tokens: int = 0          # uncontaminated prefix length (tokens)
    stored_tokens: int = 0         # tokens physically written to CPU
    prealloc_tokens: int = 0       # reserved-ahead space (adjacent)


class KVCacheReuseManager:
    def __init__(self, num_cpu_blocks: int, block_size_tokens: int = 16,
                 initial_group_blocks: int = 60, enabled: bool = True,
                 prealloc_blocks: int = 16):
        self.mgr = DynamicBlockGroupManager(
            num_cpu_blocks, block_size_tokens,
            initial_group_blocks=initial_group_blocks)
        self.block_size = block_size_tokens
        self.enabled = enabled
        self.prealloc_blocks = prealloc_blocks
        self.copies: Dict[int, CpuCopy] = {}
        # priority snapshot used to pick contamination victims
        self.priorities: Dict[int, float] = {}
        # live-priority fallback for rids never seen by update_priority
        # (the engine points this at scheduler.priority); without it an
        # unseen rid would default to 0.0 and become a preferential
        # contamination victim regardless of its true priority
        self.priority_fn: Optional[Callable[[int], float]] = None
        self.n_contaminations = 0
        # swap-ins of a copy shorter than the request's KV, resumed by
        # restoring the valid prefix and recomputing the rest (the
        # engine's ``_resume_short_copy``), with the tokens of each part
        self.n_short_copy_resumes = 0
        self.short_copy_restored_tokens = 0
        self.short_copy_recomputed_tokens = 0

    # ------------------------------------------------------------------

    def update_priority(self, req_id: int, priority: float) -> None:
        self.priorities[req_id] = priority

    def _priority_of(self, req_id: int) -> float:
        p = self.priorities.get(req_id)
        if p is not None:
            return p
        if self.priority_fn is not None:
            return float(self.priority_fn(req_id))
        return 0.0

    def valid_tokens(self, req_id: int) -> int:
        c = self.copies.get(req_id)
        return c.valid_tokens if (c and self.enabled) else 0

    def restorable_tokens(self, req_id: int) -> int:
        """Leading positions a swap-in may restore from the copy: its
        valid prefix, never past the CPU blocks it still holds, whether
        or not reuse across turns is enabled (the disabled baseline
        re-writes the whole context at each swap-out, and its copy too
        is contaminated and truncated for want of CPU blocks)."""
        c = self.copies.get(req_id)
        if c is None:
            return 0
        return min(c.valid_tokens, self.mgr.request_tokens(req_id))

    def note_short_copy_resume(self, restored: int, recomputed: int) -> None:
        """Count one swap-in resumed from a short copy: ``restored``
        tokens came from the copy, ``recomputed`` are computed again."""
        self.n_short_copy_resumes += 1
        self.short_copy_restored_tokens += restored
        self.short_copy_recomputed_tokens += recomputed

    def plan_swap_out(self, req_id: int, total_tokens: int) -> int:
        """Tokens that actually need transfer (the increment)."""
        if not self.enabled:
            return total_tokens
        return max(0, total_tokens - self.valid_tokens(req_id))

    def record_swap_out(self, req_id: int, total_tokens: int,
                        requesting_priority: float = 0.0,
                        floor_tokens: int = 0
                        ) -> Tuple[int, List[Tuple[int, int]]]:
        """Allocate CPU space for the increment and mark the copy valid up
        to ``total_tokens``.  Returns (increment_tokens, cpu_runs) where
        cpu_runs are the contiguous CPU block runs written.

        ``floor_tokens``: positions ``[0, floor)`` are pinned GPU-resident
        (a shared prefix-cache prefix) and never transferred; the copy is
        considered valid from position 0 anyway so all block-index math
        stays unchanged — the CPU blocks below the floor are phantoms that
        are allocated but never written or read."""
        copy = self.copies.setdefault(req_id, CpuCopy())
        if not self.enabled:
            # baseline: the whole context is re-written every preemption
            # (same in-place CPU blocks — the allocation only grows)
            self._ensure_cpu_tokens(req_id, total_tokens, requesting_priority)
            copy.valid_tokens = total_tokens
            copy.stored_tokens = total_tokens
            return total_tokens, self.mgr.request_runs(req_id)
        if floor_tokens:
            f = min(floor_tokens, total_tokens)
            copy.valid_tokens = max(copy.valid_tokens, f)
            copy.stored_tokens = max(copy.stored_tokens, copy.valid_tokens)
        inc = max(0, total_tokens - copy.valid_tokens)
        if inc == 0:
            return 0, []
        self._ensure_cpu_tokens(req_id, total_tokens, requesting_priority)
        # allocation may have been refused (only higher-priority copies
        # left to contaminate): the valid prefix is capped by what is
        # physically stored on CPU.  The pinned floor stays valid even
        # when the phantom blocks below it were contaminated away.
        cap = self.mgr.request_tokens(req_id)
        new_valid = max(min(total_tokens, cap), copy.valid_tokens)
        inc = max(0, new_valid - copy.valid_tokens)
        copy.valid_tokens = new_valid
        copy.stored_tokens = new_valid
        # adjacent preallocation for the NEXT turn's increment
        try:
            self.mgr.allocate_tokens(req_id,
                                     self.prealloc_blocks * self.block_size)
            self.mgr.note_tokens(req_id, self.prealloc_blocks * self.block_size)
            copy.prealloc_tokens = self.prealloc_blocks * self.block_size
        except OutOfBlocksError:
            pass
        return inc, self.mgr.request_runs(req_id)

    def record_swap_in(self, req_id: int) -> int:
        """Swap-in reads the valid prefix; the CPU copy is RETAINED.
        Returns tokens transferred h2d."""
        return self.valid_tokens(req_id)

    def invalidate(self, req_id: int) -> None:
        """Failure containment (DESIGN.md §7): a failed d2h increment
        left the CPU copy's tail unwritten — nothing beyond what was
        previously valid can be trusted, and since the failed increment's
        extent within the allocation is unknown the whole copy is
        conservatively voided.  The ALLOCATION is kept (the request may
        still be live and swap out again later); only the trusted extent
        drops to zero, so ``valid_tokens`` never advertises bytes that
        never arrived."""
        c = self.copies.get(req_id)
        if c is not None:
            c.valid_tokens = 0
            c.stored_tokens = 0
            # nothing valid is stored, so nothing is "reserved ahead" of
            # it either: a stale reserve would make the next
            # record_swap_out under-report the adjacent preallocation and
            # a later contamination over-shrink the victim's valid prefix
            c.prealloc_tokens = 0

    def release(self, req_id: int) -> None:
        """Conversation finished: drop the copy."""
        self.mgr.release_request(req_id)
        self.copies.pop(req_id, None)
        self.priorities.pop(req_id, None)

    # ------------------------------------------------------------------
    # cross-replica migration (DESIGN.md §11)
    # ------------------------------------------------------------------

    def export_copy(self, req_id: int) -> Optional[Dict[str, object]]:
        """Metadata of one copy for migration to another replica's reuse
        manager: the trusted prefix extent plus the token-ordered CPU
        block ids backing it (the engine reads the actual bytes out of
        ``PagedPools.cpu`` — block ids are meaningless across pools).
        The local copy is NOT released here; the engine owns the
        exactly-once handoff."""
        c = self.copies.get(req_id)
        if c is None:
            return None
        return {"valid_tokens": c.valid_tokens,
                "block_ids": list(self.mgr.request_block_ids(req_id))}

    def import_copy(self, req_id: int, valid_tokens: int,
                    priority: float = 0.0) -> List[int]:
        """Install a migrated copy: allocate CPU space for the imported
        prefix (contaminating lower-priority copies if the pool is full,
        same as a local swap-out) and mark it valid up to what was
        actually allocated.  Returns the token-ordered CPU block ids the
        engine must write the migrated KV bytes into; the caller trims
        its write — and the advertised prefix — to the returned
        capacity."""
        if req_id in self.copies:
            raise ValueError(f"request {req_id} already has a CPU copy")
        copy = self.copies.setdefault(req_id, CpuCopy())
        if valid_tokens <= 0 or not self.enabled:
            return []
        self._ensure_cpu_tokens(req_id, valid_tokens, priority)
        cap = self.mgr.request_tokens(req_id)
        copy.valid_tokens = min(valid_tokens, cap)
        copy.stored_tokens = copy.valid_tokens
        self.priorities[req_id] = priority
        return list(self.mgr.request_block_ids(req_id))

    # ------------------------------------------------------------------
    # space management & contamination
    # ------------------------------------------------------------------

    def _ensure_cpu_tokens(self, req_id: int, total_tokens: int,
                           requesting_priority: float) -> None:
        """Grow the request's CPU allocation to ``total_tokens`` (both
        the reuse increment and the disabled-baseline rewrite only ever
        GROW — rewrites land in the same blocks), contaminating
        lower-priority copies when the pool is full."""
        copy = self.copies[req_id]
        have = self.mgr.request_tokens(req_id)
        need = total_tokens - have
        if need <= 0:
            # the increment fits inside already-reserved space: whatever
            # part of the preallocation it consumes is no longer
            # reserved-ahead (stale prealloc bookkeeping made
            # contamination over-shrink a victim's valid prefix)
            copy.prealloc_tokens = min(copy.prealloc_tokens,
                                       have - total_tokens)
            return
        while need > 0:
            try:
                self.mgr.allocate_tokens(req_id, need)
                self.mgr.note_tokens(req_id, need)
                if copy.prealloc_tokens:
                    copy.prealloc_tokens = 0   # consumed by growth
                return
            except OutOfBlocksError:
                if not self._contaminate_one(requesting_priority, req_id):
                    # cannot make space: copy is best-effort truncated —
                    # the fill consumes the whole reserve, so nothing
                    # stays preallocated-ahead
                    copy.prealloc_tokens = 0
                    return

    def _contaminate_one(self, requesting_priority: float,
                         requester: int) -> bool:
        """Reclaim CPU space from the lowest-priority other copy; shrink its
        valid prefix (tail-first eviction keeps the longest usable prefix)."""
        victims = [r for r in self.copies if r != requester
                   and self.mgr.request_tokens(r) > 0]
        if not victims:
            return False
        victim = min(victims, key=self._priority_of)
        if self._priority_of(victim) >= requesting_priority:
            # only strictly-lower-priority copies may be contaminated
            # (paper §2.2); an equal-priority victim would let two peers
            # ping-pong each other's prefixes away
            return False
        vcopy = self.copies[victim]
        # release the victim's LAST group (tail-first)
        if self.mgr.release_tail_group(victim) is None:
            return False
        remaining_cap = self.mgr.request_tokens(victim)
        vcopy.valid_tokens = min(vcopy.valid_tokens,
                                 max(0, remaining_cap - vcopy.prealloc_tokens))
        vcopy.stored_tokens = min(vcopy.stored_tokens, vcopy.valid_tokens)
        vcopy.prealloc_tokens = 0
        self.n_contaminations += 1
        return True

    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        g = self.mgr.granularity_stats()
        return {"cpu_copies": len(self.copies),
                "cpu_free_blocks": self.mgr.free_blocks(),
                "contaminations": self.n_contaminations,
                "short_copy_resumes": self.n_short_copy_resumes,
                "short_copy_restored_tokens": self.short_copy_restored_tokens,
                "short_copy_recomputed_tokens":
                    self.short_copy_recomputed_tokens,
                **{f"cpu_{k}": v for k, v in g.items()}}
