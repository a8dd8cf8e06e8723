"""Cross-request prefix cache — radix tree over the paged GPU pool.

FastSwitch's reuse mechanism (§3.3) only eliminates redundant I/O *within*
a session; at scale the dominant redundancy is *across* users sharing
prompt prefixes (system prompts, few-shot templates, RAG boilerplate).
This module keeps a radix/prefix tree keyed on full-block token-id chunks:
each tree node owns exactly ONE physical GPU block, registered with the
`DynamicBlockGroupManager` as a single-block group under a unique negative
owner id, so the pool's tiling invariants keep holding and eviction goes
through the same public tail-release API contamination uses
(`release_tail_group`).

Sharing model (copy-on-write by construction):
  * only FULL prompt blocks are ever cached — the block holding a
    request's first decode slot is always private, so a sharer never
    writes a cached block; divergence below block granularity simply
    means the walk stops earlier and the tail stays private;
  * a request *maps* a root path of nodes (its shared prefix) and holds a
    per-block refcount via ``mgr.ref_block``; refcounted blocks can never
    reach the free list (asserted in ``mgr._release``);
  * insertion donates a freshly prefilled request's leading full prompt
    blocks to new nodes (``mgr.transfer_prefix_blocks``) — the physical
    blocks don't move, so the donor's composed block table is unchanged.

Eviction is leaf-only and fairness-aware (Locality-aware Fair Scheduling,
arXiv 2501.14312: locality and fairness must be co-designed): only leaves
with refcount 0 (no live mapper) are evictable, scored by
``age / (1 + hits) / (eps + priority_ema)`` — old, rarely-hit prefixes
whose historical users carried little scheduler priority (virtual-token
credit, arXiv 2401.00588) go first.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# Node owner ids live far below the engine's internal phantom owners
# (e.g. the allocation-pressure rid -7777); negative rids are exempt from
# the live-request block-ownership invariant (B2).
NODE_OWNER_BASE = -100_000

_PRIO_EPS = 0.05
_PRIO_DECAY = 0.8


class PrefixNode:
    __slots__ = ("key", "block", "owner", "parent", "children",
                 "last_use_us", "hits", "prio_ema")

    def __init__(self, key: Tuple[int, ...], block: int, owner: int,
                 parent: Optional["PrefixNode"]):
        self.key = key
        self.block = block
        self.owner = owner
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "PrefixNode"] = {}
        self.last_use_us = 0.0
        self.hits = 0
        self.prio_ema = 0.0

    def depth_path(self) -> List["PrefixNode"]:
        path: List[PrefixNode] = []
        node: Optional[PrefixNode] = self
        while node is not None:
            path.append(node)
            node = node.parent
        path.reverse()
        return path


class PrefixCache:
    """Radix tree of cached full-block prompt prefixes over the GPU pool."""

    def __init__(self, mgr, block_size: int):
        self.mgr = mgr
        self.bs = block_size
        self.roots: Dict[Tuple[int, ...], PrefixNode] = {}
        self._maps: Dict[int, List[PrefixNode]] = {}   # rid -> mapped path
        self._next_owner = NODE_OWNER_BASE
        self.n_nodes = 0
        self.n_hits = 0
        self.n_misses = 0
        self.n_insertions = 0
        self.n_evictions = 0
        self.tokens_saved = 0

    # ------------------------------------------------------------------
    # probing / mapping
    # ------------------------------------------------------------------

    def _cacheable_blocks(self, ids: List[int]) -> int:
        """Full prompt blocks eligible for sharing.  The block containing
        the last prompt token doubles as the first decode slot's block, so
        at least one prompt token always stays private — this also keeps
        the engine's ``reused < context`` prefill precondition true."""
        return max(0, (len(ids) - 1) // self.bs)

    def _walk(self, ids: List[int], limit: int) -> List[PrefixNode]:
        path: List[PrefixNode] = []
        children = self.roots
        for b in range(limit):
            key = tuple(ids[b * self.bs:(b + 1) * self.bs])
            node = children.get(key)
            if node is None:
                break
            path.append(node)
            children = node.children
        return path

    def match_tokens(self, ids: List[int]) -> int:
        """Longest cached prefix (tokens) usable for this prompt."""
        return len(self._walk(ids, self._cacheable_blocks(ids))) * self.bs

    def shared_tokens(self, rid: int) -> int:
        return len(self._maps.get(rid, ())) * self.bs

    def blocks_for(self, rid: int) -> List[int]:
        """Physical blocks of rid's mapped shared prefix, token order."""
        return [n.block for n in self._maps.get(rid, ())]

    def acquire(self, rid: int, ids: List[int], *, now_us: float = 0.0,
                priority: float = 0.0) -> int:
        """Probe the tree for ``ids`` and pin the matched prefix for
        ``rid``.  Returns the shared token count (block-aligned)."""
        assert rid not in self._maps, f"rid {rid} already holds a mapping"
        path = self._walk(ids, self._cacheable_blocks(ids))
        for node in path:
            self.mgr.ref_block(node.block)
            node.last_use_us = now_us
            node.hits += 1
            node.prio_ema = (_PRIO_DECAY * node.prio_ema
                             + (1.0 - _PRIO_DECAY) * priority)
        if path:
            self._maps[rid] = path
            self.n_hits += 1
            self.tokens_saved += len(path) * self.bs
        else:
            self.n_misses += 1
        return len(path) * self.bs

    def release(self, rid: int) -> None:
        """Drop rid's mapping (teardown/finish): unpin its shared blocks."""
        for node in self._maps.pop(rid, ()):
            self.mgr.unref_block(node.block)

    # ------------------------------------------------------------------
    # insertion (block donation after a completed prefill)
    # ------------------------------------------------------------------

    def insert(self, rid: int, ids: List[int], *, now_us: float = 0.0,
               priority: float = 0.0) -> int:
        """Donate rid's leading private full-prompt blocks to the tree and
        remap them as shared for rid.  Returns tokens newly shared.

        If a concurrent identical admission inserted a deeper path since
        rid's match, rid's private copy would fork duplicate nodes at an
        interior position — skip instead (rid keeps its private blocks;
        the next sharer hits the deeper path)."""
        cap = self._cacheable_blocks(ids)
        mapped = self._maps.get(rid, [])
        path = self._walk(ids, cap)
        if len(path) != len(mapped) or cap <= len(mapped):
            return 0
        n_new = cap - len(mapped)
        owners = list(range(self._next_owner,
                            self._next_owner - n_new, -1))
        self._next_owner -= n_new
        blocks = self.mgr.transfer_prefix_blocks(rid, owners)
        parent = mapped[-1] if mapped else None
        children = parent.children if parent else self.roots
        base = len(mapped)
        for i, (owner, block) in enumerate(zip(owners, blocks)):
            b = base + i
            key = tuple(ids[b * self.bs:(b + 1) * self.bs])
            node = PrefixNode(key, block, owner, parent)
            node.last_use_us = now_us
            node.prio_ema = priority
            children[key] = node
            self.mgr.ref_block(block)          # rid keeps using it, shared
            mapped.append(node)
            parent, children = node, node.children
            self.n_nodes += 1
        self._maps[rid] = mapped
        self.n_insertions += n_new
        return n_new * self.bs

    # ------------------------------------------------------------------
    # fairness-aware eviction
    # ------------------------------------------------------------------

    def _score(self, node: PrefixNode, now_us: float) -> float:
        age = max(now_us - node.last_use_us, 0.0) + 1.0
        return age / (1.0 + node.hits) / (_PRIO_EPS + node.prio_ema)

    def _evictable(self) -> List[PrefixNode]:
        out = []
        stack = list(self.roots.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif self.mgr.block_refcount(node.block) == 0:
                out.append(node)
        return out

    def evict(self, n_blocks: int, *, now_us: float = 0.0) -> int:
        """Free up to ``n_blocks`` GPU blocks by evicting unreferenced
        leaves, worst fairness score first.  Returns blocks freed."""
        freed = 0
        while freed < n_blocks:
            cands = self._evictable()
            if not cands:
                break
            node = max(cands, key=lambda n: self._score(n, now_us))
            released = self.mgr.release_tail_group(node.owner)
            assert released is not None, \
                f"node owner {node.owner} block {node.block} not releasable"
            if node.parent is not None:
                node.parent.children.pop(node.key, None)
            else:
                self.roots.pop(node.key, None)
            self.n_nodes -= 1
            self.n_evictions += 1
            freed += 1
        return freed

    # ------------------------------------------------------------------

    def iter_nodes(self):
        stack = list(self.roots.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def mappings(self) -> Dict[int, List[PrefixNode]]:
        return self._maps

    def stats(self) -> Dict[str, float]:
        total = self.n_hits + self.n_misses
        return {"nodes": self.n_nodes,
                "blocks": self.n_nodes,
                "hits": self.n_hits,
                "misses": self.n_misses,
                "hit_rate": (self.n_hits / total) if total else 0.0,
                "tokens_saved": self.tokens_saved,
                "insertions": self.n_insertions,
                "evictions": self.n_evictions,
                "mapped_requests": len(self._maps)}
