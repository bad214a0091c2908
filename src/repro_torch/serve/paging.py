"""BlockPool + RadixPrefixCache: the host side of the paged KV pool.

The port's copy of the reference's ``repro/serve/paging.py`` (plain
Python over ints; it imports nothing of the reference).

The slot pool reserves one contiguous ``(S_max, ...)`` region per
stream: a short request strands most of its slot, and a shared system
prompt is prefilled and stored again for every request.  The paged pool
cuts KV into fixed-size blocks and lets streams share them:

* :class:`BlockPool` — a refcounted allocator over ``num_blocks``
  physical blocks.  Every block is in exactly one of three states:

  - **free**: virgin or evicted, on the free list;
  - **referenced**: ``ref > 0`` — held by one or more live streams
    (``used_bytes`` counts exactly these);
  - **cold**: ``ref == 0`` but its content is still registered in the
    radix cache — a later request with the same prefix re-attaches to
    it for free.  Cold blocks are recyclable: when the free list runs
    dry, the least-recently-cooled *leaf* block is evicted from the
    radix and reused (leaf-only eviction keeps every cached path
    reachable root-first).

* :class:`RadixPrefixCache` — a trie over *full* token blocks: one edge
  per ``block_size``-token chunk, each node pinned to the physical block
  holding that chunk's KV.  ``match`` walks the longest cached
  block-aligned prefix; ``insert`` registers new paths first-writer-wins
  (an existing path keeps its blocks, so a prefix's KV is stored once
  however many concurrent requests carry it).

Copy-on-write: a **shared block is never written**.  A stream attaches
to matched prefix blocks read-only (refcount bump) and allocates fresh
blocks from the divergence point; the partial tail block is always
private, so divergence never copies.

Device tensors, gathers and scatters live in
:class:`repro_torch.serve.pool.PagedKVPoolManager`.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque

#: default tokens per KV block (vLLM's default; small enough that a
#: short request wastes at most block_size - 1 positions)
DEFAULT_BLOCK_SIZE = 16


class PoolExhausted(RuntimeError):
    """No KV capacity for an allocation: the free list is dry and (for
    the paged pool) every cold block is an interior prefix of a live
    stream.  The serve tier treats this as *pressure*, not a crash —
    admission retries later, a mid-decode grow preempts the stream —
    so it gets its own type rather than a bare ``RuntimeError``."""


class _RadixNode:
    __slots__ = ("parent", "edge", "children", "block")

    def __init__(self, parent=None, edge=None, block=None):
        self.parent = parent
        self.edge = edge            # tuple of block_size token ids
        self.children = {}          # edge tuple -> _RadixNode
        self.block = block          # physical block id


class RadixPrefixCache:
    """Trie over full token blocks -> physical block ids."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root = _RadixNode()
        self.by_block: dict[int, _RadixNode] = {}

    def _chunks(self, tokens) -> list[tuple[int, ...]]:
        bs = self.block_size
        return [tuple(tokens[i:i + bs])
                for i in range(0, len(tokens) - bs + 1, bs)]

    def match(self, tokens) -> list[int]:
        """Physical block ids of the longest cached block-aligned
        prefix of ``tokens`` (full blocks only)."""
        node, ids = self.root, []
        for ch in self._chunks(tokens):
            nxt = node.children.get(ch)
            if nxt is None:
                break
            ids.append(nxt.block)
            node = nxt
        return ids

    def insert(self, tokens, block_ids) -> list[int]:
        """Register ``tokens``' full blocks under ``block_ids``,
        first-writer-wins: a path segment that already exists keeps its
        existing block.  Returns the ids now live along the path (the
        caller diffs against its own ids to find redundant blocks)."""
        node, kept = self.root, []
        for ch, bid in zip(self._chunks(tokens), block_ids):
            nxt = node.children.get(ch)
            if nxt is None:
                nxt = _RadixNode(node, ch, bid)
                node.children[ch] = nxt
                self.by_block[bid] = nxt
            kept.append(nxt.block)
            node = nxt
        return kept

    def __contains__(self, bid: int) -> bool:
        return bid in self.by_block

    def is_leaf(self, bid: int) -> bool:
        return not self.by_block[bid].children

    def forget(self, bid: int) -> None:
        """Drop a (leaf) block's path segment from the trie."""
        node = self.by_block.pop(bid)
        assert not node.children, "evicting an interior radix block"
        del node.parent.children[node.edge]


@dataclasses.dataclass
class BlockPoolStats:
    prefix_queries: int = 0      # admissions that consulted the radix
    prefix_block_hits: int = 0   # blocks attached instead of allocated
    evictions: int = 0           # cold blocks recycled under pressure


class BlockPool:
    """Refcounted fixed-size block allocator with prefix reuse."""

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.free: deque[int] = deque(range(num_blocks))
        self.ref = [0] * num_blocks
        self.radix = RadixPrefixCache(block_size)
        #: ref == 0 but radix-registered, LRU order (oldest first)
        self.cold: OrderedDict[int, None] = OrderedDict()
        self.stats = BlockPoolStats()

    # -- capacity -----------------------------------------------------------

    def free_capacity(self) -> int:
        """Blocks allocatable right now (free list + recyclable cold)."""
        return len(self.free) + len(self.cold)

    def used_blocks(self) -> int:
        """Blocks held live (ref > 0) — the byte-accounting base."""
        return self.num_blocks - self.free_capacity()

    # -- alloc / refcount ---------------------------------------------------

    def alloc(self) -> int:
        """A fresh private block (ref = 1); recycles the LRU cold leaf
        when the free list is dry."""
        if self.free:
            bid = self.free.popleft()
        else:
            bid = self._evict_cold()
        self.ref[bid] = 1
        return bid

    def _evict_cold(self) -> int:
        for bid in self.cold:            # LRU order, leaf-only
            if self.radix.is_leaf(bid):
                del self.cold[bid]
                self.radix.forget(bid)
                self.stats.evictions += 1
                return bid
        raise PoolExhausted(
            "paged KV pool exhausted: no free blocks and every cold "
            "block is an interior prefix of a live stream")

    def retain(self, bid: int) -> None:
        """Attach to an existing block (a radix prefix hit warms it)."""
        if self.ref[bid] == 0:
            self.cold.pop(bid, None)
        self.ref[bid] += 1

    def release(self, bid: int) -> None:
        """Drop one reference.  At zero, a radix-registered block goes
        cold (reusable by prefix, recyclable LRU); an unregistered one
        is freed outright."""
        assert self.ref[bid] > 0, bid
        self.ref[bid] -= 1
        if self.ref[bid] == 0:
            if bid in self.radix:
                self.cold[bid] = None
                self.cold.move_to_end(bid)
            else:
                self.free.append(bid)

    # -- prefix sharing -----------------------------------------------------

    def match_retain(self, tokens, max_tokens: int | None = None
                     ) -> list[int]:
        """Longest cached block-aligned prefix of ``tokens`` (capped at
        ``max_tokens``), every matched block retained."""
        ids = self.match_peek(tokens, max_tokens)
        for bid in ids:
            self.retain(bid)
        self.stats.prefix_queries += 1
        self.stats.prefix_block_hits += len(ids)
        return ids

    def match_peek(self, tokens, max_tokens: int | None = None
                   ) -> list[int]:
        """:meth:`match_retain` without the retain or the stats —
        admission feasibility checks and insert-time dedup."""
        ids = self.radix.match(tokens)
        if max_tokens is not None:
            ids = ids[:max_tokens // self.block_size]
        return ids

    def register(self, tokens, block_ids) -> list[int]:
        """Publish ``tokens``' full blocks to the radix under
        ``block_ids`` (first-writer-wins; see
        :meth:`RadixPrefixCache.insert`)."""
        return self.radix.insert(tokens, block_ids)
