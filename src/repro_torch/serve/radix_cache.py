"""Radix-tree prefix cache: shared-prompt KV reuse over pool blocks (the
JAX package's serve/radix_cache.py; host-side numpy, no torch).

The dominant serving pattern the ROADMAP targets — millions of users hitting
a handful of system prompts / few-shot templates — re-computes the same
prompt KV on every admission. This module keeps a token-trie over
*block-aligned* prompt prefixes: each node is one KV block (``block_size``
tokens) plus the pool block id holding its K/V, keyed by the exact token
content of that block. Admission walks the trie with the new prompt's
context tokens; every matched node's block can be wired straight into the
slot's block table instead of being re-prefetched and re-computed.

Ownership protocol (with serve/kv_cache.BlockAllocator's refcounts):

* ``insert`` (at prefill completion) takes one cache-owned reference per
  newly created node — the block outlives its computing request.
* ``match`` (at admission) returns the chain; the engine ``incref``\\ s the
  matched blocks (slot-owned reference) and ``pin``\\ s the chain so eviction
  cannot touch a prefix that a live slot is attending through.
* ``unpin`` + ``free`` at retirement drop the slot's holds; the cache's own
  reference keeps the prefix warm for the next match.
* ``evict`` pops least-recently-used *unpinned leaves* (children before
  parents, so the trie stays prefix-closed) and drops their cache reference,
  returning blocks to the pool when no slot still holds them.

Copy-on-write divergence: when the prompt's context ends mid-block and a
cached child block's leading tokens match the whole remaining context,
``match`` reports that block as ``cow_src``. The engine copies it into a
slot-private block (kv_cache.copy_pool_block) — decode will write the next
position *into* that block, and the write must never land in the shared
cached copy.

Bit-exactness: a cached block's contents are exactly what the chunk-grid
prefill (serve/engine) computed for those positions given the same token
prefix, so wiring it into a table is indistinguishable — bit for bit — from
recomputing it. The trie key being the literal token content is what makes
that safe: two prompts share a node only if every token in the block (and in
every ancestor block) matches.

Quantized pools (kv_bits < 16) carry scale metadata *with* the block: the
per-(block, head) exponent planes are indexed by the same pool block id a
node stores, so sharing or COW-copying a block shares/copies its scales
automatically (kv_cache.copy_pool_block moves payload and exponents
together). The one sharing mode that would break under a shared block
exponent — partial-block COW, whose donor exponent depends on the donor's
trailing positions — is disabled by the engine at kv_bits < 16
(engine._match_prefix rounds such matches down to the chunk grid), keeping
full-block reuse exact: identical chunk writes produce identical payloads
AND identical exponents.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.kv_cache import BlockAllocator


class RadixNode:
    """One cached block: `tokens` (exactly block_size of them) -> `block`."""
    __slots__ = ("tokens", "block", "children", "parent", "pins",
                 "last_access")

    def __init__(self, tokens: Tuple[int, ...], block: int,
                 parent: Optional["RadixNode"]):
        self.tokens = tokens
        self.block = block
        self.children: Dict[Tuple[int, ...], RadixNode] = {}
        self.parent = parent
        self.pins = 0
        self.last_access = 0


@dataclasses.dataclass
class PrefixMatch:
    """Result of a prompt-context lookup.

    `blocks`/`nodes` cover `tokens_matched` full-block tokens; `cow_src` is
    the pool block to copy-on-write from when a partial block covers the
    rest of the context (then `cow_tokens` counts those extra positions).
    """
    blocks: List[int]
    nodes: List[RadixNode]
    tokens_matched: int
    cow_src: Optional[int] = None
    cow_node: Optional[RadixNode] = None
    cow_tokens: int = 0


class RadixCache:
    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.allocator = allocator
        self.block_size = block_size
        self.root = RadixNode((), 0, None)     # sentinel; holds no block
        self._clock = 0
        self.evictions = 0                     # blocks evicted (lifetime)
        self.hits = 0
        self.misses = 0

    # --- bookkeeping -----------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @property
    def clock(self) -> int:
        """Monotone mutation clock: advances on every commit, insert, and
        eviction, so a caller may memoize a `match()` result for exactly as
        long as the clock stands still."""
        return self._clock

    def _keys(self, tokens: np.ndarray) -> List[Tuple[int, ...]]:
        bs = self.block_size
        n = len(tokens) // bs
        return [tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
                for i in range(n)]

    def num_nodes(self) -> int:
        out, stack = 0, [self.root]
        while stack:
            n = stack.pop()
            out += len(n.children)
            stack.extend(n.children.values())
        return out

    def block_ids(self) -> List[int]:
        """Pool block ids held by resident nodes — what the telemetry
        refcount-leak check can account to the cache (one cache-owned
        reference per node)."""
        return [n.block for n in self.nodes()]

    def nodes(self) -> List["RadixNode"]:
        """Every resident node (the root sentinel excluded) — the engine's
        invariant audit cross-checks each node's pin count and cache-owned
        block reference against live slot reservations."""
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                out.append(c)
                stack.append(c)
        return out

    def pin_summary(self) -> dict:
        """Snapshot-manifest view of the trie: resident/pinned node and
        block counts plus the pinned block ids. Diagnostic only — KV pools
        are not persisted, so a restored engine rebuilds the trie from
        recomputed prefills; the summary lets a snapshot reader see what
        reuse state existed at capture time (and audits can cross-check the
        pinned set against the live slots recorded alongside it)."""
        nodes = self.nodes()
        pinned = [n for n in nodes if n.pins > 0]
        return {
            "nodes": len(nodes),
            "pinned_nodes": len(pinned),
            "blocks": len(nodes),
            "pinned_blocks": sorted(n.block for n in pinned),
            "total_pins": sum(n.pins for n in pinned),
        }

    # --- lookup ----------------------------------------------------------

    def match(self, tokens: np.ndarray) -> PrefixMatch:
        """Longest block-aligned cached prefix of `tokens` (+ COW probe).

        Pure lookup — no LRU bump, no hit/miss accounting. The engine calls
        `commit()` with the result once the admission actually lands, so
        requeued (over-committed) retries cannot inflate hit metrics or
        churn the LRU clock.
        """
        bs = self.block_size
        node, blocks, nodes = self.root, [], []
        for key in self._keys(tokens):
            child = node.children.get(key)
            if child is None:
                break
            node = child
            blocks.append(node.block)
            nodes.append(node)
        m = PrefixMatch(blocks, nodes, len(blocks) * bs)
        rem = len(tokens) - m.tokens_matched
        if 0 < rem < bs:
            # partial-block divergence: a child whose leading tokens match
            # the whole remaining context covers it copy-on-write
            want = tuple(int(t) for t in tokens[m.tokens_matched:])
            for key, child in node.children.items():
                if key[:rem] == want:
                    m.cow_src = child.block
                    m.cow_node = child
                    m.cow_tokens = rem
                    break
        return m

    def commit(self, m: PrefixMatch) -> None:
        """Record a match the engine actually used: bump the LRU clock on
        the matched chain (and COW donor) and count the hit/miss."""
        now = self._tick()
        for n in m.nodes:
            n.last_access = now
        if m.cow_node is not None:
            m.cow_node.last_access = now
        if m.tokens_matched or m.cow_tokens:
            self.hits += 1
        else:
            self.misses += 1

    # --- pinning ---------------------------------------------------------

    def pin(self, nodes: List[RadixNode]) -> None:
        for n in nodes:
            n.pins += 1

    def unpin(self, nodes: List[RadixNode]) -> None:
        for n in nodes:
            assert n.pins > 0, "unpin of unpinned node"
            n.pins -= 1

    # --- insertion -------------------------------------------------------

    def insert(self, tokens: np.ndarray, blocks: List[int], *,
               node: Optional[RadixNode] = None):
        """Record full-block `tokens`, sharing `blocks` (the admitting
        slot's table entries), walking/creating from `node` (default: the
        root — pass a previous call's deepest node to publish a prompt
        incrementally chunk by chunk without re-walking the whole prefix).

        Existing nodes are kept (first writer wins — their block already has
        readers); new nodes take a cache-owned reference on the request's
        block. Returns (deepest, walked): every node along the inserted
        path, created or pre-existing. A caller that keeps `deepest` as a
        resume cursor must pin `walked` so eviction cannot detach it.
        """
        node = node or self.root
        walked: List[RadixNode] = []
        now = self._tick()
        for i, key in enumerate(self._keys(tokens)):
            child = node.children.get(key)
            if child is None:
                child = RadixNode(key, int(blocks[i]), node)
                self.allocator.incref([child.block])
                node.children[key] = child
            child.last_access = now
            walked.append(child)
            node = child
        return node, walked

    # --- eviction --------------------------------------------------------

    def _unpinned_leaves(self) -> List[RadixNode]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                if c.children:
                    stack.append(c)
                elif c.pins == 0:
                    out.append(c)
        return out

    def evictable_blocks(self) -> int:
        """Blocks eviction could reclaim right now *for the free list*:
        cache-referenced blocks in subtrees with no pinned node whose only
        remaining holder is the cache itself. Iterative post-order — cached
        chains can be thousands of nodes deep, far past Python's recursion
        limit."""
        order, stack = [], [self.root]
        while stack:
            n = stack.pop()
            order.append(n)
            stack.extend(n.children.values())
        pinned_below: Dict[int, bool] = {}
        total = 0
        for n in reversed(order):               # children before parents
            pinned = (n.pins > 0
                      or any(pinned_below[id(c)]
                             for c in n.children.values()))
            pinned_below[id(n)] = pinned
            if (n is not self.root and not pinned
                    and self.allocator.refcount(n.block) == 1):
                total += 1
        return total

    def evictable_after_unpin(self, nodes: List[RadixNode]) -> int:
        """What-if headroom: `evictable_blocks()` as if one pin — and the
        matching slot-owned block reference — were dropped from each entry
        of `nodes`. Pass the concatenated pinned chains of prospective
        preemption victims; pure query, mutates nothing.

        The engine's preemption path uses this to check that preempting a
        victim set can actually yield enough reclaimable blocks to admit
        the blocked head before it pays for any preempt (victims whose
        prefix is also pinned by a surviving slot free nothing)."""
        drop: Dict[int, int] = {}
        for n in nodes:
            drop[id(n)] = drop.get(id(n), 0) + 1
        order, stack = [], [self.root]
        while stack:
            n = stack.pop()
            order.append(n)
            stack.extend(n.children.values())
        pinned_below: Dict[int, bool] = {}
        total = 0
        for n in reversed(order):               # children before parents
            d = drop.get(id(n), 0)
            assert n.pins >= d, "unpin what-if exceeds actual pins"
            pinned = (n.pins - d > 0
                      or any(pinned_below[id(c)]
                             for c in n.children.values()))
            pinned_below[id(n)] = pinned
            if (n is not self.root and not pinned
                    and self.allocator.refcount(n.block) - d == 1):
                total += 1
        return total

    def evict(self, need_free: int) -> int:
        """LRU-evict unpinned leaves until the allocator has `need_free`
        free blocks (or nothing evictable remains). Returns blocks whose
        cache reference was dropped.

        One leaf scan seeds a min-heap on last_access; parents join the
        heap as their last child is evicted, so reclaiming k blocks is
        O(nodes + k log nodes), not k full trie scans."""
        if self.allocator.free_blocks >= need_free:
            return 0
        heap = [(n.last_access, id(n), n) for n in self._unpinned_leaves()]
        heapq.heapify(heap)
        dropped = 0
        while self.allocator.free_blocks < need_free and heap:
            _, _, victim = heapq.heappop(heap)
            if victim.children or victim.pins > 0:
                continue                        # stale entry
            del victim.parent.children[victim.tokens]
            self.allocator.free([victim.block])
            dropped += 1
            self.evictions += 1
            p = victim.parent
            if p is not self.root and not p.children and p.pins == 0:
                heapq.heappush(heap, (p.last_access, id(p), p))
        if dropped:
            self._clock += 1      # invalidate memoized matches: the evicted
            # nodes must never be pinned through a stale PrefixMatch
        return dropped
