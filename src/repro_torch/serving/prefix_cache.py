"""Radix-tree prefix cache: cross-request KV reuse over shared pages.

Production traffic is dominated by shared prompt prefixes (system
prompts, few-shot templates, multi-turn histories).  Because the paged
attention kernels read KV strictly through a per-slot page table, two
sequences whose token prefixes agree can point their table rows at the
*same physical pages* -- the SGLang/FlashInfer observation -- with zero
kernel changes.  This module owns the host-side index that makes the
match: a radix tree over **page-sized token blocks**.

Each tree node is one full page of tokens (key: the ``page_size`` token
ids) mapping to the physical page holding that block's K/V.  A node's
path from the root spells the whole token prefix, so the KV in its page
-- which depends on every earlier position -- is valid for exactly the
sequences that reach it.  Matching therefore walks full blocks only:
page-aligned by construction, never a partial page.

Lifecycle:

* ``insert`` (at sequence retire) publishes a sequence's full prefix
  blocks, taking one cache reference per newly created node so the
  pages stay resident after their writer's slot is freed.
* ``match`` (at admission) returns the longest cached page run for a
  token sequence and touches the path's LRU clock.
* ``evict`` (free list running low, or the ``capacity_pages`` soft cap)
  removes least-recently-used **leaves** whose page only the index still
  references -- a page some live slot shares is never reclaimed from
  under it.  Removing a leaf may expose its parent as the next
  candidate, so long dead branches unwind back-to-front.

The index never touches device memory: it holds references via
``PagedKVCache.incref``/``decref`` and deals purely in page numbers.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.paged_cache import PagedKVCache


class _Node:
    """One page-sized token block: ``block`` (token-id tuple) -> the
    physical ``page`` holding its KV."""
    __slots__ = ("block", "page", "children", "parent", "last_used")

    def __init__(self, block, page: int, parent: Optional["_Node"],
                 last_used: int):
        self.block = block
        self.page = page
        self.children: Dict[tuple, "_Node"] = {}
        self.parent = parent
        self.last_used = last_used


class RadixPrefixIndex:
    """Token-block radix tree mapping page-aligned prompt prefixes to
    resident physical page runs of a :class:`PagedKVCache`."""

    def __init__(self, cache: PagedKVCache, page_size: Optional[int] = None,
                 capacity_pages: int = 0, *, metrics=None):
        self.cache = cache
        self.page_size = page_size or cache.page_size
        # cap on index-held pages (0 = unbounded, the pool is the bound)
        self.capacity_pages = capacity_pages
        self._root = _Node(None, -1, None, 0)
        self._clock = 0
        self._nodes = 0
        self.stats = {"hits": 0, "misses": 0, "hit_tokens": 0,
                      "inserted_blocks": 0, "evicted_blocks": 0,
                      "freed_pages": 0}
        # optional MetricsRegistry (serving/metrics.py): the stats dict
        # stays the authority stats() exposes, the registry mirrors each
        # key as a cumulative ``prefix_<key>_total`` counter
        self._counters = ({k: metrics.counter(f"prefix_{k}_total")
                           for k in self.stats}
                          if metrics is not None else None)

    def _bump(self, key: str, n: int = 1) -> None:
        self.stats[key] += n
        if self._counters is not None:
            self._counters[key].inc(n)

    # -- introspection --------------------------------------------------
    def __len__(self) -> int:
        return self._nodes

    @property
    def cached_pages(self) -> int:
        """Pages the index holds references on (== node count)."""
        return self._nodes

    def page_refs(self) -> Dict[int, int]:
        """page -> number of index references, for
        ``PagedKVCache.check_invariants(extern_refs=...)``."""
        refs: Dict[int, int] = {}
        for node in self._walk():
            refs[node.page] = refs.get(node.page, 0) + 1
        return refs

    def _walk(self) -> List[_Node]:
        out, stack = [], list(self._root.children.values())
        while stack:
            node = stack.pop()
            out.append(node)
            stack.extend(node.children.values())
        return out

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _blocks(self, tokens) -> List[tuple]:
        tokens = np.asarray(tokens).reshape(-1)
        ps = self.page_size
        return [tuple(int(t) for t in tokens[i:i + ps])
                for i in range(0, (len(tokens) // ps) * ps, ps)]

    # -- match / insert / evict -----------------------------------------
    def match(self, tokens, record: bool = True) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: returns ``(pages,
        matched_tokens)`` with ``matched_tokens`` a whole number of
        pages.  Touches the matched path's LRU clock.  ``record=False``
        leaves the hit/miss stats alone -- the scheduler probes the
        index on every admission attempt (a blocked head-of-queue
        request re-plans each engine step) and records only the match
        an admission actually consumes, via ``record_match``."""
        now = self._tick()
        node, pages = self._root, []
        for block in self._blocks(tokens):
            child = node.children.get(block)
            if child is None:
                break
            child.last_used = now
            pages.append(child.page)
            node = child
        matched = len(pages) * self.page_size
        if record:
            self.record_match(matched)
        return pages, matched

    def record_match(self, matched_tokens: int) -> None:
        """Count one consumed match in the hit/miss stats."""
        self._bump("hits" if matched_tokens else "misses")
        self._bump("hit_tokens", matched_tokens)

    def insert(self, tokens, pages: List[int]) -> int:
        """Publish the full blocks of ``tokens`` backed by ``pages``
        (one physical page per block, already resident).  Existing nodes
        are kept -- a duplicate block computed by a concurrent cold run
        keeps the first-published page and the newcomer's copy simply
        loses its last reference at retire.  Returns the number of new
        nodes (pages the index took a reference on)."""
        blocks = self._blocks(tokens)
        if len(blocks) != len(pages):
            raise ValueError(
                f"{len(blocks)} full blocks but {len(pages)} pages")
        now = self._tick()
        node, new = self._root, 0
        for block, page in zip(blocks, pages):
            child = node.children.get(block)
            if child is None:
                self.cache.incref(page)
                child = _Node(block, page, node, now)
                node.children[block] = child
                self._nodes += 1
                new += 1
            else:
                child.last_used = now
            node = child
        self._bump("inserted_blocks", new)
        self.trim_to_capacity()
        return new

    def _evictable_leaves(self, free_only: bool) -> List[_Node]:
        return [n for n in self._walk()
                if not n.children
                and (not free_only or self.cache.refcount(n.page) == 1)]

    def _remove_leaf(self, leaf: _Node) -> bool:
        del leaf.parent.children[leaf.block]
        self._nodes -= 1
        self._bump("evicted_blocks")
        freed = self.cache.decref(leaf.page)
        self._bump("freed_pages", freed)
        return freed

    def evict(self, n_pages: int) -> int:
        """LRU-leaf eviction for page pressure: remove least-recently-
        used leaves until ``n_pages`` pages have actually returned to
        the free list (or nothing evictable remains).  Only leaves whose
        page the index alone references are touched -- eviction must
        produce free pages, not strip index entries off live sharers.
        Returns the number of pages freed."""
        freed = 0
        while freed < n_pages:
            leaves = self._evictable_leaves(free_only=True)
            if not leaves:
                break
            freed += self._remove_leaf(min(leaves,
                                           key=lambda n: n.last_used))
        return freed

    def trim_to_capacity(self) -> None:
        """Enforce the ``capacity_pages`` cap on index-held pages by
        dropping LRU leaves (shared or not -- a live sharer keeps its
        own reference, only the index entry goes)."""
        while self.capacity_pages and self._nodes > self.capacity_pages:
            leaves = self._evictable_leaves(free_only=False)
            if not leaves:
                break
            self._remove_leaf(min(leaves, key=lambda n: n.last_used))
