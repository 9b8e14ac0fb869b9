"""Radix-tree paged prefix cache: token-block trie over the global KV pool.

Copied from ``seldon_core_tpu/runtime/radix.py`` (host-only code over the
port's ``PageAllocator`` refcounts, ``runtime/batcher.py``). The page pool
makes KV a pool of fixed-size pages addressed through per-slot block
tables; this module makes shared prompt prefixes a FIRST-CLASS occupant of
that pool (SGLang's RadixAttention, Zheng et al. 2024, on vLLM's
block-sharing substrate, Kwon et al. SOSP 2023). The trie is keyed on
fixed-size token blocks — one node = one token block = one page — so a
cached prefix is not an entry to copy but a path of pages to POINT AT:

- **hit = block-table entries.** ``match_and_pin`` walks the prompt's
  blocks down the trie in O(prompt blocks) and returns the pages already
  holding that prefix's KV; admission writes them into the slot's block
  row (one in-place row write) and chunk-prefills only the uncached suffix.
  No gather, no page copy — the pages are shared in place.
- **copy-on-write for partial blocks.** A prompt that runs PAST a cached
  path's full blocks but only part-way into a node's block (or repeats a
  cached sequence exactly — the match is capped at prompt-1 so the last
  token always prefills and yields first-token logits) cannot write into
  the shared page: it gets ONE fresh page plus one page copy
  (``cow_page_copy``, a CUDA graph replay on a card — values copied,
  position rows past the valid length masked to PAD_POS so a previous
  occupant's run-ahead tail is never attended), and its writes land in
  the copy.
- **refcounts live in the allocator.** ``PageAllocator.alloc`` hands out
  pages at refcount 1; the trie adopts a completed slot's pages by simply
  keeping that reference, ``match_and_pin`` retains matched pages for the
  slot, and every release path is one uniform ``free`` (decrement,
  free-list on zero). A page's refcount IS the shared-ownership truth:
  refcount 1 = trie-only (evictable), >1 = some live slot's block table
  points at it (never evictable).
- **insert-in-place at completion.** ``insert`` walks the finished slot's
  prompt+generated token blocks back into the trie, transferring page
  ownership node-by-node — no dense export, no import program. Blocks the
  trie already holds free the slot's duplicate page instead (trie-path
  equality implies bit-identical KV: a block's KV depends on its whole
  token prefix, which IS the path). Only tokens whose KV is provably
  written are inserted (everything but the final credited token — its KV
  is only written when it is FED to a later step, which run-ahead may or
  may not have dispatched).
- **LRU-by-leaf eviction.** When the allocator runs dry the batcher asks
  the trie to give pages back: leaves with refcount 1 evict in
  least-recently-matched order (a parent is touched whenever a child
  matches, so parents are never younger than their children and eviction
  is deepest-coldest-first). Live-referenced pages are structurally
  excluded — eviction can shrink the cache, never corrupt a slot.

Concurrency: every public method takes ``self._lock``. Mutations come
from the batcher loop's thread (admission, insert, evict); reads
additionally come from transport threads (``stats`` at /metrics scrape,
``match_len`` from ``LLMServer.prefix_match_len``) — the lock is what makes
the probe safe to call from anywhere. Trie methods call allocator methods
while holding the trie lock (lock order trie -> allocator, one direction
only; the allocator never calls back). tests/test_torch_radix.py runs the
JAX package's trie call sequences on both copies and holds returns,
stats and refcounts equal.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["RadixPrefixCache", "RankedPrefixCache"]


class _Node:
    """One token block = one pool page. ``key`` is the block's tokens
    (len == page_size for full nodes, shorter for a partial tail leaf —
    only full nodes may have children, so every root-to-node path spells
    a position-aligned token prefix). ``last_match`` is a logical clock
    tick (monotonic counter, not wall time) for LRU eviction."""

    __slots__ = ("key", "page", "children", "last_match")

    def __init__(self, key: Tuple[int, ...], page: Optional[int]):
        self.key = key
        self.page = page
        # first-token -> [nodes]: siblings may share key prefixes (the
        # trie never splits nodes — a page belongs to exactly one node),
        # so lookup picks the longest-matching candidate per step
        self.children: Dict[int, List["_Node"]] = {}
        self.last_match = 0


def _common(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


def _common_at(key: Sequence[int], ids: Sequence[int], off: int,
               limit: int) -> int:
    """Common prefix length of ``key`` and ``ids[off:limit]`` without
    materializing the slice (the match walk compares in place)."""
    n = min(len(key), limit - off)
    for i in range(n):
        if key[i] != ids[off + i]:
            return i
    return n


class RadixPrefixCache:
    """See module docstring. ``allocator`` is the batcher's PageAllocator
    (the refcount authority); ``page_size`` the tokens per block/page;
    ``bytes_per_block`` the HBM bytes one cached block's KV occupies
    (feeds the bytes-saved counter: a hit's blocks are bytes NOT copied
    and NOT recomputed)."""

    def __init__(self, allocator: Any, page_size: int,
                 bytes_per_block: int = 0):
        self._allocator = allocator
        self.page_size = int(page_size)
        self.bytes_per_block = int(bytes_per_block)
        self._lock = threading.Lock()
        self._root = _Node((), None)
        self._tick = 0
        self._blocks = 0             # nodes holding a page
        # lifetime counters (llm_stats -> metrics/registry.py
        # seldon_llm_prefix_*); mutated only under the lock
        self.hit_blocks_total = 0
        self.hit_tokens_total = 0
        self.cow_copies_total = 0
        self.evicted_blocks_total = 0
        self.bytes_saved_total = 0
        self.match_work_total = 0    # nodes visited by match walks — the
        #                              O(prompt blocks) regression signal

    # ------------------------------------------------------------------
    # lookup
    # ------------------------------------------------------------------
    def _walk(self, ids: Sequence[int], limit: int, touch: bool):
        """Shared walk: longest cached coverage of ``ids[:limit]``.
        Returns (k0, pages, cow) where ``pages`` are the full-block nodes'
        pages in path order and ``cow`` is (src_page, valid_tokens) when
        the walk ended part-way into a node's block (None otherwise);
        k0 counts full-block tokens + the cow's valid tokens."""
        ps = self.page_size
        limit = min(max(int(limit), 0), len(ids))
        node = self._root
        k0 = 0          # tokens matched == the walk's offset into ids
        pages: List[int] = []
        cow: Optional[Tuple[int, int]] = None
        work = 0
        while k0 < limit:
            # compare in place at offset k0 — slicing the remainder per
            # block would make the walk O(L^2/ps) in token copies under
            # the trie lock (this runs per routing probe, per admission)
            best, best_t = None, 0
            for cand in node.children.get(ids[k0], ()):
                work += 1
                t = _common_at(cand.key, ids, k0, limit)
                if t > best_t:
                    best, best_t = cand, t
            if best is None:
                break
            if touch:
                self._tick += 1
                best.last_match = self._tick
            if best_t == len(best.key) == ps:
                pages.append(best.page)
                k0 += ps
                node = best
                continue
            # ended inside a block (or consumed a partial tail leaf
            # whole): the page is shared and about to be written past
            # best_t — copy-on-write territory
            cow = (best.page, best_t)
            k0 += best_t
            break
        self.match_work_total += work + 1
        return k0, pages, cow

    def match_len(self, ids: Sequence[int]) -> int:
        """Cached-prefix length in TOKENS for ``ids`` — the cheap probe
        ReplicaSet's prefix-aware routing calls from transport threads.
        Read-only: no pins, no LRU touch."""
        with self._lock:
            k0, _, _ = self._walk(ids, len(ids), touch=False)
            return k0

    def match_and_pin(self, ids: Sequence[int], limit: Optional[int] = None,
                      full_blocks_only: bool = False):
        """Longest cached prefix of ``ids[:limit]``, pinned for a slot.

        Returns ``(k0, pages, cow)``: ``pages`` are the shared full-block
        pages (allocator-retained here — the caller's block table may
        point at them until it frees them), ``cow`` is (src_page,
        valid_tokens) for a partial-block continuation the caller must
        copy before writing (``full_blocks_only=True`` drops it — the
        disaggregated path shares whole blocks only), and ``k0`` is the
        total matched tokens. The cow SOURCE page is retained too: the
        caller's very next allocation may trigger eviction, and an
        unpinned source could be evicted and handed back as a fresh page
        while the pending copy still references it — the caller frees
        the cow pin once the copy is dispatched (or on its failure
        path). Callers cap ``limit`` at len(ids)-1 so at least one token
        always prefills (its logits seed the first sampled token — no
        logits storage needed in the trie)."""
        if limit is None:
            limit = len(ids)
        with self._lock:
            k0, pages, cow = self._walk(ids, limit, touch=True)
            if full_blocks_only and cow is not None:
                k0 -= cow[1]
                cow = None
            pins = pages + ([cow[0]] if cow is not None else [])
            if pins:
                self._allocator.retain(pins)
            return k0, pages, cow

    def record_hit(self, k0: int, n_shared: int, cow: bool) -> None:
        """Tally one SERVED hit. Deliberately separate from
        ``match_and_pin``: an admission can match, fail to fund its fresh
        pages, unpin, and retry every loop turn — counting at match time
        would inflate the headline reuse counters once per retry (and
        claim COW copies that were never dispatched). The batcher calls
        this exactly once, after the admission is funded."""
        with self._lock:
            self.hit_blocks_total += n_shared + (1 if cow else 0)
            self.hit_tokens_total += k0
            if cow:
                self.cow_copies_total += 1
            # full shared blocks are bytes neither copied nor recomputed;
            # a cow block is recompute saved but one page-copy paid, so it
            # does not count toward bytes saved
            self.bytes_saved_total += n_shared * self.bytes_per_block

    # ------------------------------------------------------------------
    # insertion (completion path)
    # ------------------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               n_shared: int) -> set:
        """Walk a finished slot's token history back into the trie.

        ``tokens`` is the provably-written history (prompt + all but the
        last credited token), ``pages`` the slot's block-row pages in
        block order (shared trie pages first, then owned), ``n_shared``
        how many of them are already trie-owned. Ownership of owned pages
        transfers in place: adopted pages keep the slot's allocator
        reference (the trie's ref from now on), duplicates of blocks the
        trie already holds are freed here. Returns the set of owned page
        ids this call consumed (adopted or freed) — the caller must NOT
        free them again; everything else (shared pins, surplus tail
        pages) stays the caller's to release."""
        ps = self.page_size
        tokens = list(tokens)
        n_full = len(tokens) // ps
        tail = len(tokens) % ps
        consumed: set = set()
        with self._lock:
            node = self._root
            for i in range(n_full):
                if i >= len(pages):
                    break
                block = tuple(tokens[i * ps:(i + 1) * ps])
                page = pages[i]
                own = i >= n_shared
                node = self._insert_block(node, block, page, own, consumed)
                if node is None:
                    return consumed
            if tail and n_full < len(pages):
                self._insert_tail(node, tuple(tokens[n_full * ps:]),
                                  pages[n_full], n_full >= n_shared,
                                  consumed)
            return consumed

    def _insert_block(self, node: _Node, block: Tuple[int, ...], page: int,
                      own: bool, consumed: set) -> Optional[_Node]:
        """One full block under ``node``; returns the node to descend
        into (None aborts the walk — the path can no longer be spelled)."""
        self._tick += 1
        siblings = node.children.get(block[0], [])
        exact = next((c for c in siblings if c.key == block), None)
        if exact is not None:
            # the trie already holds this block (same path = same KV
            # bits); an owned duplicate page goes back to the pool
            if own and page != exact.page:
                self._allocator.free([page])
                consumed.add(page)
            exact.last_match = self._tick
            return exact
        if not own:
            # a shared page whose node vanished mid-flight (cannot happen
            # while pinned — defensive): stop inserting, never adopt a
            # page the slot does not own
            return None
        partial = next(
            (c for c in siblings
             if len(c.key) < len(block) and block[:len(c.key)] == c.key),
            None)
        if partial is not None and self._allocator.refs_of(partial.page) == 1:
            # upgrade the colder partial leaf in place: our page holds the
            # same leading KV plus more valid positions
            self._allocator.free([partial.page])
            self.evicted_blocks_total += 1
            self._blocks -= 1
            partial.key = block
            partial.page = page
            partial.last_match = self._tick
            consumed.add(page)
            self._blocks += 1
            return partial
        child = _Node(block, page)
        child.last_match = self._tick
        node.children.setdefault(block[0], []).append(child)
        consumed.add(page)
        self._blocks += 1
        return child

    def _insert_tail(self, node: _Node, tail: Tuple[int, ...], page: int,
                     own: bool, consumed: set) -> None:
        """The final partial block (valid tokens < page_size)."""
        if not own:
            return
        self._tick += 1
        siblings = node.children.get(tail[0], [])
        covering = next(
            (c for c in siblings
             if len(c.key) >= len(tail) and c.key[:len(tail)] == tail),
            None)
        if covering is not None:
            # an existing node already serves every lookup ours could
            self._allocator.free([page])
            consumed.add(page)
            covering.last_match = self._tick
            return
        shorter = next(
            (c for c in siblings
             if len(c.key) < len(tail) and tail[:len(c.key)] == c.key),
            None)
        if shorter is not None and self._allocator.refs_of(shorter.page) == 1:
            self._allocator.free([shorter.page])
            self.evicted_blocks_total += 1
            shorter.key = tail
            shorter.page = page
            shorter.last_match = self._tick
            consumed.add(page)
            return
        child = _Node(tail, page)
        child.last_match = self._tick
        node.children.setdefault(tail[0], []).append(child)
        consumed.add(page)
        self._blocks += 1

    # ------------------------------------------------------------------
    # eviction
    # ------------------------------------------------------------------
    def evict(self, need_free: int) -> bool:
        """Give pages back until the allocator has ``need_free`` free
        pages. Only leaves whose page refcount is 1 (trie-only — no live
        slot's block table references them) are candidates, coldest
        ``last_match`` first. Batched: one trie walk + one allocator lock
        acquisition (``refs_map``) per ROUND, evicting as many of the
        round's candidates as needed coldest-first, then re-walking only
        if interior nodes became leaves (so relief is O(depth) walks, not
        O(evicted_pages) — this runs on the admission/page-grow path
        where each extra O(nodes) lock round-trip is a serving stall).
        Returns True when the target was reached."""
        with self._lock:
            while self._allocator.free_count() < need_free:
                leaves = self._evictable_leaves()
                if not leaves:
                    return False
                leaves.sort(key=lambda pn: pn[1].last_match)
                for parent, node in leaves:
                    if self._allocator.free_count() >= need_free:
                        break
                    sibs = parent.children[node.key[0]]
                    sibs.remove(node)
                    if not sibs:
                        del parent.children[node.key[0]]
                    self._allocator.free([node.page])
                    self._blocks -= 1
                    self.evicted_blocks_total += 1
            return True

    def _iter_nodes(self):
        """(parent, node) pairs of every trie node — THE traversal,
        shared by stats/clear/eviction (callers hold the lock)."""
        stack = [(self._root, c)
                 for cs in self._root.children.values() for c in cs]
        while stack:
            parent, node = stack.pop()
            yield parent, node
            stack.extend((node, c)
                         for cs in node.children.values() for c in cs)

    def _evictable_leaves(self):
        """All (parent, leaf) pairs whose page refcount is 1 — one trie
        walk, refcounts read in one batched allocator call."""
        pairs = [(p, n) for p, n in self._iter_nodes() if not n.children]
        refs = self._allocator.refs_map([n.page for _, n in pairs])
        return [pn for pn, rc in zip(pairs, refs) if rc == 1]

    def clear(self) -> None:
        """Drop every cached block (frees the trie's page references)."""
        with self._lock:
            pages = [n.page for _, n in self._iter_nodes()]
            if pages:
                self._allocator.free(pages)
            self.evicted_blocks_total += len(pages)
            self._root = _Node((), None)
            self._blocks = 0

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """One consistent snapshot for llm_stats (counters are lifetime
        tallies — metrics/registry.py syncs them with the catch-up
        idiom). ``prefix_shared_pages`` counts cached pages some live
        slot currently references (refcount > 1). One trie walk, one
        allocator lock acquisition (``refs_map``) — this runs per
        /metrics scrape and must not serialize admissions O(nodes)
        times."""
        with self._lock:
            cached_pages = [n.page for _, n in self._iter_nodes()]
            shared = sum(
                1 for rc in self._allocator.refs_map(cached_pages)
                if rc > 1)
            return {
                "prefix_cached_blocks": self._blocks,
                "prefix_shared_pages": shared,
                "prefix_hit_blocks": self.hit_blocks_total,
                "prefix_hit_tokens": self.hit_tokens_total,
                "prefix_cow_copies": self.cow_copies_total,
                "prefix_evicted_blocks": self.evicted_blocks_total,
                "prefix_bytes_saved": self.bytes_saved_total,
            }


class RankedPrefixCache:
    """The prefix trie of a batcher whose slots split over 'data' ranks
    (``runtime/batcher.py``): one ``RadixPrefixCache`` a data rank, keyed
    so, each over its rank's pools (``tries[d]``, its allocator a
    ``PoolView``), so a hit's pages always lie in the admitted slot's own
    pools. Under 'seq' a node's page lies on the seq rank its depth names
    (``depth mod sp``, the round robin a block table follows), so a path of
    k blocks covers a sequence's first k pages on every seq rank. The
    probes a server makes (``match_len``: the longest over the ranks,
    ``stats``: the ranks summed, ``clear``) cover every rank."""

    def __init__(self, tries: Sequence[RadixPrefixCache]):
        self.tries = list(tries)
        self.page_size = self.tries[0].page_size
        self.bytes_per_block = self.tries[0].bytes_per_block

    def match_len(self, ids: Sequence[int]) -> int:
        return max(t.match_len(ids) for t in self.tries)

    def clear(self) -> None:
        for t in self.tries:
            t.clear()

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for t in self.tries:
            for k, v in t.stats().items():
                out[k] = out.get(k, 0) + v
        return out
