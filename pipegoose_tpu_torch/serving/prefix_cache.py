"""Content-addressed prefix cache over the paged KV pool.

The counterpart of ``pipegoose_tpu/serving/prefix_cache.py``: a host-side
index that turns the refcounted :class:`~pipegoose_tpu_torch.serving.
kv_pool.PagePool` into a content-addressed store. It maps token content
to page ids and never touches device memory.

- **One page a node.** The trie is keyed by page-aligned token blocks
  (the ``page_size`` ids that produced a page's KV), chained parent to
  child, so a lookup walks the prompt page by page. Equal chains mean
  equal token prefixes and so equal KV: no false sharing.
- **Sharing is a refcount.** A hit adds a reference to each matched page
  (``pool.share``); the cache holds one reference of its own per cached
  page, so pages outlive the request that wrote them.
- **Copy-on-write for mid-page tails.** Where the prompt leaves a cached
  child block part way, the matching head of that block is still valid
  KV: ``lookup`` reports it as a COW candidate and the engine duplicates
  the page (``kv_pool.copy_page``) before the request writes its own
  tail into the copy.
- **Eviction takes refcount-1 LRU leaves.** Only pages no live request
  shares, and only trie leaves, least recently touched first on a
  deterministic clock. ``evictable_count`` feeds the scheduler's
  admission ledger, which counts ``free + evictable`` as capacity.

Every pool call names its owner for an attached memory ledger (the
``owner=`` of ``PagePool.share`` / ``release``): a hit's pages are the request's, its COW source the
request's COW pin, the cache's own references ``("cache",)``. The host
tier's ``restorable_len`` and spill hook wait for the port's KV tiers
(ROADMAP.md queue A, item A12).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pipegoose_tpu_torch.serving.kv_pool import PagePool


class _Node:
    """One cached page: the block of token ids it holds and trie links."""

    __slots__ = ("block", "page", "parent", "children", "last_used")

    def __init__(self, block: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.block = block
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0

    def __repr__(self):  # debugging only
        return f"_Node(page={self.page}, used={self.last_used})"


@dataclass
class PrefixHit:
    """A lookup's result: ``pages`` are fully matched shared pages
    (``tokens = len(pages) * page_size`` prompt tokens that need no
    prefill), ``cow_page`` / ``cow_tokens`` an optional partly matched
    page whose first ``cow_tokens`` positions are valid after a copy.
    ``nodes`` is the matched chain, touched for recency by
    :meth:`PrefixCache.acquire` (lookup itself changes nothing)."""

    pages: List[int] = field(default_factory=list)
    tokens: int = 0
    cow_page: Optional[int] = None
    cow_tokens: int = 0
    nodes: List[_Node] = field(default_factory=list)

    @property
    def total_tokens(self) -> int:
        return self.tokens + self.cow_tokens


class PrefixCache:
    """Radix index mapping page-aligned prompt prefixes to pool pages.
    ``evictions`` counts the pages :meth:`evict` has given back."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._roots: Dict[Tuple[int, ...], _Node] = {}
        # flat view for eviction scans, keyed by identity (O(1) removal)
        self._nodes: Dict[int, _Node] = {}
        self._clock = 0                 # deterministic LRU ordering
        self.evictions = 0

    # -- queries -----------------------------------------------------------

    @property
    def cached_pages(self) -> int:
        return len(self._nodes)

    def evictable_count(self) -> int:
        """Pages that leaf-first eviction can recover now: a node counts
        only when its page and its whole subtree are at refcount 1. A
        refcount-1 inner node can sit above a child pinned by a live
        request (``insert`` hangs a request's new pages under existing
        nodes without referencing them), and never becomes a leaf while
        that child lives. The admission ledger spends this count, so it
        is exact, not an upper bound."""
        memo = {}

        def recoverable(node: _Node) -> bool:
            got = memo.get(id(node))
            if got is None:
                got = self.pool.refcount(node.page) == 1 and all(
                    recoverable(c) for c in node.children.values())
                memo[id(node)] = got
            return got

        return sum(1 for n in self._nodes.values() if recoverable(n))

    def longest_prefix_len(self, tokens: Sequence[int]) -> int:
        """Token length of the longest cached prefix of ``tokens`` (full
        pages plus a COW candidate's matching head), capped at
        ``len(tokens) - 1`` as admission caps it. Read-only: pins
        nothing, touches no clock, evicts nothing."""
        n = len(np.asarray(tokens))
        if n <= 1:
            return 0
        return self.lookup(tokens, max_tokens=n - 1).total_tokens

    def lookup(self, tokens: Sequence[int], max_tokens: Optional[int] = None
               ) -> PrefixHit:
        """Longest cached prefix of ``tokens``, capped at ``max_tokens``
        (callers cap at ``len(tokens) - 1``: one token must be forwarded
        for its logits). Full-page matches first; where the walk stops,
        the child block sharing the longest head with the remaining
        tokens becomes the COW candidate. Changes nothing: pair with
        :meth:`acquire`."""
        toks = [int(t) for t in np.asarray(tokens)]
        cap = len(toks) if max_tokens is None else min(max_tokens, len(toks))
        ps = self.page_size
        hit = PrefixHit()
        children = self._roots
        i = 0
        while (i + 1) * ps <= cap:
            node = children.get(tuple(toks[i * ps:(i + 1) * ps]))
            if node is None:
                break
            hit.pages.append(node.page)
            hit.nodes.append(node)
            children = node.children
            i += 1
        hit.tokens = i * ps
        rem = toks[i * ps:cap]
        if rem and children:
            best, best_m = None, 0
            # sorted: a deterministic winner among equal head matches
            for blk in sorted(children):
                m = 0
                for a, b in zip(blk, rem):
                    if a != b:
                        break
                    m += 1
                if m > best_m:
                    best, best_m = children[blk], m
            if best is not None:
                hit.cow_page = best.page
                hit.cow_tokens = best_m
                hit.nodes.append(best)
        return hit

    # -- mutation ----------------------------------------------------------

    def acquire(self, hit: PrefixHit, owner=None) -> None:
        """Take one reference per matched page for a request and refresh
        the chain's recency. The COW source is pinned too: the copy runs
        later, and an eviction in between could hand the page to a new
        owner; the engine releases that pin right after ``copy_page``.
        ``owner`` (a request uid, or None for an anonymous pin) labels the
        references for the memory ledger."""
        pool = self.pool
        if hit.pages:
            pool.share(hit.pages, owner=("req", owner))
        if hit.cow_page is not None:
            pool.share([hit.cow_page], owner=("cow", owner))
        for node in hit.nodes:
            self._clock += 1
            node.last_used = self._clock

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Register a prefilled request's page-aligned prefix: page ``i``
        of ``pages`` holds the KV of tokens ``[i*ps, (i+1)*ps)``. Only full
        pages go in (a partial tail keeps growing under its owner).
        Existing nodes win; each new node's page gains the cache's own
        reference. Returns the number of new nodes."""
        toks = [int(t) for t in np.asarray(tokens)]
        ps = self.page_size
        n_full = min(len(toks) // ps, len(pages))
        children = self._roots
        parent = None
        added = 0
        for i in range(n_full):
            blk = tuple(toks[i * ps:(i + 1) * ps])
            node = children.get(blk)
            if node is None:
                node = _Node(blk, int(pages[i]), parent)
                self.pool.share([node.page], owner=("cache",))
                children[blk] = node
                self._nodes[id(node)] = node
                added += 1
            self._clock += 1
            node.last_used = self._clock
            parent = node
            children = node.children
        return added

    def evict(self, n: int) -> int:
        """Give up to ``n`` pages back to the pool, each time the least
        recently used leaf whose page only the cache references. Returns
        how many were freed (fewer than ``n`` when the rest is pinned)."""
        freed = 0
        while freed < n:
            victim = None
            for node in self._nodes.values():
                if node.children or self.pool.refcount(node.page) != 1:
                    continue
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                break
            self._remove(victim)
            self.pool.release([victim.page], owner=("cache",))
            freed += 1
        self.evictions += freed
        return freed

    def clear(self) -> int:
        """Drop every unpinned page; pinned pages stay for their readers."""
        return self.evict(len(self._nodes))

    def _remove(self, node: _Node) -> None:
        siblings = (node.parent.children if node.parent is not None
                    else self._roots)
        del siblings[node.block]
        del self._nodes[id(node)]
