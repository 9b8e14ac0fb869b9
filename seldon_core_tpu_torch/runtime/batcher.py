"""Continuous batching for LLM decode over the paged KV pool (or the dense
slot pool), ported to PyTorch.

Port of ``seldon_core_tpu/runtime/batcher.py``. Requests join
and leave a fixed pool of S decode slots between decode steps, so one decode
program serves overlapping requests at arbitrary arrival times:

- KV lives in a GLOBAL pool of fixed-size pages (``init_paged_kv_caches``)
  addressed through a per-slot block table on the device; pages are handed
  out by ``PageAllocator`` (host-side, lock-guarded) as sequences grow;
- admission is weighted-fair (``runtime/scheduler.py``: SLO classes and
  tenants by stride scheduling, EDF by deadline within a tenant, per-tenant
  quotas shedding at submit); its prefill runs in chunks of
  ``prefill_chunk`` tokens interleaved with decode steps, written straight
  into the pool through the slot's block-table row (staged in one fixed row
  buffer; one admission prefills at a time). An interactive request
  blocked by a staged batch-class prefill puts that job back in the queue
  (preemption: a staged job only, never an active slot, at most once a
  request);
- on page exhaustion the newest tenant is shed (503 + Retry-After) — the
  decode loop never raises; a sole tenant that outgrows the pool stops with
  the tokens it has.

Pipelined, fused decode. Per-slot token, position and sampling-key state
stay on the device, updated in place by each dispatch, so dispatching one
step never waits for the last one's tokens. A dispatch runs K steps
(``decode_fuse_steps``; ``_pick_k`` falls back to K = 1 while a request
waits or a prefill is mid-flight, or when a slot has fewer than K steps of
room, so there are only two programs). On a card each dispatch is one
replay of a CUDA graph of the K-step program, and each prefill chunk one
replay of the graph of its chunk length, all captured once when the
batcher is built (``servers/step_graph.py``); a dispatch's replay is
followed by a non-blocking copy of its tokens into pinned host memory and
an event. On the CPU the same programs run eagerly. The host reads a
dispatch's tokens (waiting on that
event only) after later ones are already enqueued, so the device never
idles on host bookkeeping. Up to ``decode_pipeline_depth`` dispatches are
in flight. A slot that finishes, or is freed and re-admitted, between a
dispatch and its drain is detected by a per-slot generation counter and its
trailing tokens are dropped, never surfaced; so are the tokens of a fused
block past a slot's EOS, budget or cache length. Their KV writes land in
pages that are reset or rewritten strictly after them in stream order.

Speculative decoding (``spec_mode`` "ngram" or "draft", ``spec_k`` = K).
A dispatch is then one fused draft + verify step
(``LLMServer._get_spec_step``; on a card one replay of its CUDA graph,
captured once per batcher in place of the decode graphs): each slot
advances 1..cap+1 tokens, a count the host learns only at drain. The
dispatch computes each slot's cap on the host (``runtime/spec.
SpecController``'s depth, the token budget and the cache edge), stages
the caps into a fixed device buffer in stream order, grows the slot's
pages to its furthest possible write, and books the pessimistic cap + 1
tokens into the slot's dispatch-side count; the drain reconciles that to
the actual advance, feeds the controller, and credits the accepted tokens
under the same (slot, gen) mask and EOS / budget / cache-edge stops as a
plain step (an EOS inside an accepted block drops the rest of it). The
slot's prompt + generated history lives on the device (``hist``), seeded at
admission; in draft mode so does a dense draft-model cache, prefilled at
admission (eagerly). Fused steps do not combine with speculation.

Radix prefix cache (``prefix_cache_size`` > 0 on the server;
``runtime/radix.py``). A trie of token blocks over the pool's pages: an
admission pins the pages that already hold its prompt's longest cached
prefix (capped at its length less one, so the last token always prefills),
puts them at the head of its block-table row and prefills only the suffix,
from ``k0``; a prefix that ends part-way into a cached block pays one
copy-on-write page copy (``cow_page_copy``, on a card a replay of the
batcher's one CoW graph) into a fresh page, which the slot then writes.
Allocation evicts least-recently-matched trie leaves no slot references
before it gives up. A finished slot inserts its prompt and every credited
token but the last (whose KV write depends on how far the run-ahead went)
back into the trie, which adopts its pages in place. The chunk and decode
graphs are unchanged: a hit only changes what the row and position
buffers they read hold.

Batched LoRA (the server's ``adapter_registry``, ``lora_rank`` > 0;
``runtime/adapters.py``). Every program the batcher runs is then the
adapted one: each slot's adapter id sits in the fixed ``_adapter_ids`` [S]
buffer (written at commit, back to 0 at release), the prefill job's in the
fixed ``_chunk_adapter`` [1] (written at staging), and each step gathers the
slot's factors from the pool by id; id 0 is the identity, so base traffic
rides the same program. A request pins its adapter from ``submit`` to its
slot's release (or its shed), so the pool never rewrites a row a live slot
gathers. The radix trie serves id-0 traffic only: an adapted admission
neither matches nor inserts (its hidden states, and so its deeper KV,
carry its deltas).

Meshes (a server sharded over a co-located mesh, ``models/sharded.py``).
The slots split into one contiguous block a 'data' rank (``max_slots``
must divide), each data rank owning its slots' pages; a sequence's page j
lies on 'seq' rank ``j mod sp`` (round robin, so page growth adds one page
to one rank); every (data, seq) pair has its own pool, its 'model' ranks
holding their KV heads of it. The pages share one id space partitioned by
pool (``PageAllocator(pools=)``): the host logic, the block table and the
trie keep global ids, admission, growth and the LIFO shed draw on the
slot's data rank's pools, and the model cuts each rank's table from the
global one inside the same programs and graphs. The trie is one a data
rank (``RankedPrefixCache``); an admission takes a free slot of the data
rank whose trie holds the longest prefix of its prompt, then of the rank
with the most free slots. ``page_stats`` sums the pools.

Disaggregated prefill (``disaggregation="remote_prefill"`` on the server
or here; ``runtime/disagg.py``). Admission then prefills nothing here:
``_admit_remote`` reserves a slot, matches whole trie blocks (exported to the
worker as a page bucket), allocates the suffix's pages, draws the first
token's key and stages the job on a prefill worker; several jobs may be
staged at once. Each loop turn drains the ready handoffs before it
dispatches (``_consume_handoffs``): this stream waits on the handoff's
event, the bucket is imported into the slot's pages (``LLMServer.
_get_handoff_import``: one ``index_copy_`` a pool tensor, eager on the card
too), and the slot commits with the first token the worker sampled. The
batcher then captures no prefill graphs of its own: its workers capture
theirs. A staged remote job sheds on page exhaustion after a local prefill
job and before any active slot, and an interactive admission may preempt a
staged batch-class one.

The dense layout (``kv_cache_layout="dense"``, the JAX package's A/B and
parity layout). The KV lives in a slot pool of one row of ``max_len``
positions a slot and a trash column (``transformer.SlotCaches``): no pages,
allocator, block tables or trie (``page_stats`` all zero). An admission
(``_admit``) is one prefill of the whole prompt into the free slot's row,
in place and eagerly (``LLMServer._get_prefill(1, plen, max_len)``, which
resets the row first, so the previous occupant's positions are retired),
then the first token is read and the slot commits. A free slot rides along
in the fixed-shape step writing its own row, which its next admission
resets, and past the row its trash column. The dispatches are the dense
decode program (``_get_decode_step``) and the dense spec step, captured as
CUDA graphs as the paged ones are; a disaggregated admission's handoff is
inserted into the slot's row (``insert_slot_row``). Over a mesh the rows
split over 'data' and the positions over 'seq' (``models/sharded.py``).

Every pool, block-table and slot-state update is an in-place tensor update
enqueued on the same stream as the decode steps (the JAX package donated
these buffers to jitted ops and relied on device program order in the same
way), so a captured graph always reads and writes the same addresses.

Request-scoped tracing (``tracing=True``, or the tracer's ``TRACING=1``).
The batcher then holds a flight recorder (``runtime/flight.py``) and every
request records one timeline: its queue wait and admission (with a prefix
hit, or the staging of a remote job), each prefill chunk (its host enqueue
wall), the worker's handoff stages and the import, the first token (and a
fleet resume before it), each drained step with the tokens it credited (a
verify's offered and accepted drafts), page growth, sheds and preemptions,
and how it ended ("done", "shed", "preempted", "error"). The loop thread
writes them from host stamps it already takes: no event reads a device
value and none takes a lock, so a traced replay is the untraced one. A
completed request becomes a span tree rooted at the ingress's trace
(``submit(trace=)``), fed to the tracer, and a timeline for
``/debug/timeline``. Tracing off, ``_flight`` is None and each hook a None
check.

Liveness and crashes (what a replica fleet's health check reads,
``runtime/engine.ReplicaSet.check_health``). The loop stamps ``heartbeat``
(on the injectable ``clock``) at the top of every turn and then calls the
``_chaos`` hook when one is installed (``testing/faults.BatcherKiller``: a
hook that raises dies exactly where a device fault would). A loop that
dies parks its exception in ``crashed``, waits for the work already on
the stream, releases every slot's pages, pins and adapter through the
normal release path (completing every open timeline "error" first), and
fails every request; a submit to a dead loop
starts a new one on a new thread (``crashed`` back to None), which
replays the same captured graphs. If that wait itself fails (a sticky
device error), nothing is released and every later loop dies at once:
the pages and graphs of a broken context cannot be trusted.

The loop runs on a dedicated thread; ``submit`` returns a
``concurrent.futures.Future``. There is no asyncio dependency. Streaming:
``submit(on_token=...)`` fires ``on_token(tok)`` from the loop thread for
the prefill-sampled first token and for each token a drain credits (never
EOS, never a dropped run-ahead token), and ``on_token(None)`` once when the
request ends (done, shed, closed or crashed) before its future resolves.
Every future completes through ``_resolve``, which does nothing when the
future is already done: a client that cancels its future (a disconnect)
leaves the loop running; its slot decodes out its bounded ``max_new`` and
the result is dropped.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import Counter, deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.contracts.payload import SeldonError
from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.models.transformer import (
    NULL_PAGE,
    PAD_POS,
    RESERVED_PAGES,
    TRASH_PAGE,
    init_kv_caches,
    kv_cache_bytes_per_token,
    normalize_kv_cache_layout,
    reset_kv_caches,
)
from seldon_core_tpu_torch.parallel.mesh import DisaggregatedMesh
from seldon_core_tpu_torch.runtime.disagg import (HANDOFF_TRANSPORTS, HandoffReceiver,
                                                  PrefillRequest, PrefillWorkerPool,
                                                  TransferQueue, normalize_disaggregation,
                                                  same_device, staged_leaves)
from seldon_core_tpu_torch.runtime.flight import (EV_FIRST_TOKEN, EV_HANDOFF_IMPORT,
                                                  EV_HANDOFF_STAGED, EV_PAGE_GROW, EV_PREFILL,
                                                  EV_PREFILL_CHUNK, EV_PREFIX_HIT, EV_RESUME,
                                                  EV_SHED, EV_STEP, FlightRecorder)
from seldon_core_tpu_torch.runtime.radix import RadixPrefixCache, RankedPrefixCache
from seldon_core_tpu_torch.runtime.resilience import DEFAULT_RETRY_AFTER_S, ShedError
from seldon_core_tpu_torch.runtime.scheduler import (BATCH, INTERACTIVE, PendingRequest,
                                                     WeightedFairScheduler, normalize_slo_class)
from seldon_core_tpu_torch.runtime.spec import (DEFAULT_SPEC_K, SPEC_STATS_OFF,
                                                SpecController, normalize_spec_mode)
from seldon_core_tpu_torch.servers.llmserver import (LLMServer, bucket, fast_forward_key,
                                                     first_token, seed_key, split_keys)
from seldon_core_tpu_torch.servers.step_graph import (ReplayGraph, capture_cow_copy,
                                                      capture_decode_steps,
                                                      capture_prefill_chunks,
                                                      capture_spec_step)
from seldon_core_tpu_torch.tracing import get_tracer, tail_thresholds

logger = logging.getLogger(__name__)

DEFAULT_PAGE_SIZE = 64
DEFAULT_PREFILL_CHUNK = 256


def pow2_bucket(n: int, cap: int) -> int:
    """Power-of-two page-bucket size covering ``n`` pages, capped at
    ``cap`` (copied from the JAX package): the one rounding rule of every
    staged-page transfer, the handoffs and the prefix exports, on both
    sides."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


class PageAllocator:
    """Host-side refcounted free-list allocator over the global KV page
    pool (copied from the JAX package).

    Pages 0/1 are reserved (NULL/TRASH); the rest are handed out
    lowest-id-first, all-or-nothing, at refcount 1. The radix prefix cache
    (``runtime/radix.py``) shares pages between the trie and slot block
    tables by growing the refcount (``retain``); ``free`` is one uniform
    decrement-and-free-on-zero, so refcount 1 = trie-only (evictable), > 1
    = a live slot references it. Every state transition happens under
    ``self._lock``. Over-freeing raises — a page freed past zero would be
    handed to two slots and silently cross-corrupt their KV.

    ``pools`` > 1 partitions the one id space (``total_pages`` ids) into
    that many pools of equal size, pool p holding ids ``RESERVED_PAGES + p
    * cap`` onward: the (data, seq) pools of a sharded model
    (``models/sharded.py``). ``alloc(n, pool)`` draws from one,
    ``alloc_pools`` from several at once, and refcounts stay global."""

    def __init__(self, total_pages: int, page_size: int, pools: int = 1):
        if total_pages <= RESERVED_PAGES:
            raise ValueError(
                f"page pool needs > {RESERVED_PAGES} pages (got {total_pages})")
        self.total = int(total_pages)
        self.page_size = int(page_size)
        self.pools = int(pools)
        if self.pools < 1 or (self.total - RESERVED_PAGES) % self.pools:
            raise ValueError(f"{self.total - RESERVED_PAGES} pages do not split into "
                             f"{self.pools} pools")
        self.pool_cap = (self.total - RESERVED_PAGES) // self.pools
        self._lock = threading.Lock()
        # pop() from the tail hands out the lowest free id: deterministic
        # placement makes parity tests reproducible
        self._free = [list(range(RESERVED_PAGES + (p + 1) * self.pool_cap - 1,
                                 RESERVED_PAGES + p * self.pool_cap - 1, -1))
                      for p in range(self.pools)]
        self._refs: Dict[int, int] = {}   # page -> refcount (allocated only)
        self.shed_total = 0

    @property
    def capacity(self) -> int:
        return self.total - RESERVED_PAGES

    def pool_of(self, page: int) -> int:
        return (page - RESERVED_PAGES) // self.pool_cap

    def alloc(self, n: int, pool: int = 0) -> Optional[List[int]]:
        """n pages of ``pool`` at refcount 1, all-or-nothing; None when the
        pool can't cover it."""
        got = self.alloc_pools({pool: n})
        return None if got is None else got[pool]

    def alloc_pools(self, counts: Dict[int, int]) -> Optional[Dict[int, List[int]]]:
        """``{pool: n}`` pages at refcount 1, all-or-nothing across the
        pools: ``{pool: pages}``, or None."""
        with self._lock:
            if any(n > len(self._free[p]) for p, n in counts.items()):
                return None
            out = {}
            for p, n in counts.items():
                out[p] = [self._free[p].pop() for _ in range(n)]
                for page in out[p]:
                    self._refs[page] = 1
            return out

    def retain(self, pages: Sequence[int]) -> None:
        """Add one reference to each (already-allocated) page."""
        with self._lock:
            for p in pages:
                if p not in self._refs:
                    raise ValueError(f"retain of unallocated page {p}")
            for p in pages:
                self._refs[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page rejoins its pool's free list
        when its count reaches zero. Raises on a page not currently
        allocated."""
        with self._lock:
            for p in pages:
                rc = self._refs.get(p)
                if rc is None or not (RESERVED_PAGES <= p < self.total):
                    raise ValueError(f"double/invalid free of page {p}")
                if rc > 1:
                    self._refs[p] = rc - 1
                else:
                    del self._refs[p]
                    self._free[self.pool_of(p)].append(p)

    def refs_of(self, page: int) -> int:
        """Current refcount (0 = free): the trie's evictability probe."""
        with self._lock:
            return self._refs.get(page, 0)

    def refs_map(self, pages: Sequence[int]) -> List[int]:
        """Refcounts for many pages under ONE lock acquisition (the trie's
        stats and eviction walks)."""
        with self._lock:
            return [self._refs.get(p, 0) for p in pages]

    def free_count(self, pools: Optional[Sequence[int]] = None) -> int:
        """Free pages in all; with ``pools``, the fewest any of them has."""
        with self._lock:
            if pools is None:
                return sum(len(f) for f in self._free)
            return min(len(self._free[p]) for p in pools)

    def count_shed(self) -> None:
        with self._lock:
            self.shed_total += 1

    def stats(self):
        """(total, in_use, shed_total) — one consistent snapshot, the pools
        summed."""
        with self._lock:
            return (self.total, self.capacity - sum(len(f) for f in self._free),
                    self.shed_total)


class PoolView:
    """The allocator as a data rank's prefix trie sees it: its refcounts,
    and the free pages of its own (data, seq) pools (``free_count``, the
    fewest any of them has, which is what the trie's eviction waits for)."""

    def __init__(self, allocator: PageAllocator, pools: Sequence[int]):
        self._a = allocator
        self.pools = list(pools)
        self.retain = allocator.retain
        self.free = allocator.free
        self.refs_of = allocator.refs_of
        self.refs_map = allocator.refs_map

    def free_count(self) -> int:
        return self._a.free_count(self.pools)


def cow_page_copy(pools, src: torch.Tensor, dst: torch.Tensor, n_valid: torch.Tensor,
                  module=None) -> None:
    """Copy-on-write page copy (the JAX package's donated jitted
    ``cow_page_copy``), in place: for every layer, each value leaf of page
    ``src`` (K and V; an int8 pool's K, K scales, V and V scales) is copied
    into page ``dst`` whole, and the position row with offsets ``>=
    n_valid`` set to PAD_POS, so a previous occupant's run-ahead positions
    past the source's valid tokens are never attended. ``src``, ``dst``
    and ``n_valid`` are int64 tensors of one element on the pools' device
    (the batcher's fixed staging buffer): nothing is read back to the
    host, so the same call is what a CUDA graph captures
    (``servers/step_graph.capture_cow_copy``). ``module`` (the server's
    model) places the global page ids in a sharded model's pools
    (``pool_ranks``): each rank copies within its own, the others' copies
    land in their TRASH page."""
    ps = pools[0][-1].shape[1]
    keep = torch.arange(ps, device=n_valid.device) < n_valid
    ranks = [(pools, src, dst)] if module is None else [
        (layers, s_, d_) for (layers, s_), (_, d_) in zip(module.pool_ranks(pools, src),
                                                         module.pool_ranks(pools, dst))]
    for layers, s_, d_ in ranks:
        for layer in layers:
            for pool in layer[:-1]:
                pool.index_copy_(0, d_, pool.index_select(0, s_))
            pos = layer[-1]
            row = torch.where(keep, pos.index_select(0, s_)[0], PAD_POS)
            pos.index_copy_(0, d_, row[None])


def insert_slot_row(row, staged) -> None:
    """The dense handoff's insert (the JAX package's donated ``insert``),
    in place: ``row`` (one slot's row of the dense slot pool,
    ``Transformer.slot_rows``) reset to the empty state, trash column and
    all, so the previous occupant's positions are retired, then
    ``staged`` (one tuple a layer of [1, c, ...] tensors: the first c
    columns of a prefill worker's row) copied into its first c columns."""
    reset_kv_caches(row)
    for layer, st in zip(row, staged):
        for t, v in zip(layer, st):
            t[:, :v.shape[1]].copy_(v)


def _resolve(fut: Future, result: Any = None, exc: Optional[BaseException] = None) -> None:
    """Complete ``fut`` unless it is already done: a client may cancel its
    future at any time (a stream's disconnect), and the loop must never
    raise for it."""
    if fut.done():
        return
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:  # cancelled between the check and the set
        pass


def _emit(on_token, tok: Optional[int]) -> None:
    """Fire a stream's callback; one that raises is logged and ignored."""
    if on_token is None:
        return
    try:
        on_token(tok)
    except Exception:  # a client's callback must not stop the loop
        logger.exception("on_token callback failed")


class _PrefillJob:
    """One chunked admission in progress: the slot it targets, the (already
    truncated) prompt, the next write offset, the chunk length and the
    scheduler's request (tenant, class, adapter; what a preemption puts
    back). Its chunks write through the batcher's fixed row buffer, so one
    job runs at a time; decode dispatches interleave between its chunks."""

    __slots__ = ("slot", "ids", "L", "next", "chunk", "req")

    def __init__(self, slot, ids, start, chunk, req: PendingRequest):
        self.slot = slot
        self.ids = ids
        self.L = len(ids)
        self.next = start            # first position the next chunk writes
        self.chunk = chunk
        self.req = req


class _RemoteJob:
    """One admission staged on a prefill worker: the slot reserved for it
    (which holds its pages), the (already truncated) prompt, the host block
    row of its pages (NULL-padded; led by ``prefix_pages`` shared trie pages
    the worker never recomputes, then the suffix pages the import fills)
    and the scheduler's request. The handoff travels through the
    TransferQueue; this is the decode side's half, keyed by ``job_id``."""

    __slots__ = ("job_id", "slot", "ids", "L", "row", "prefix_pages", "req")

    def __init__(self, job_id, slot, ids, row, prefix_pages, req: PendingRequest):
        self.job_id = job_id
        self.slot = slot
        self.ids = ids
        self.L = len(ids)
        self.row = row
        self.prefix_pages = int(prefix_pages)
        self.req = req


class _Slot:
    __slots__ = ("future", "tokens", "true_len", "n_new", "max_new", "active",
                 "gen", "disp_new", "pages", "shared", "ids", "prefilling", "admit_seq",
                 "on_token", "t_last", "tenant", "slo_class", "adapter_id")

    def __init__(self):
        self.active = False
        # the occupant's tenant and SLO class (token / shed tallies, TTFT by
        # class) and its adapter id (from commit to release; the slot owns
        # the adapter's pin for that time)
        self.tenant = ""
        self.slo_class = INTERACTIVE
        self.adapter_id = 0
        self.future: Optional[Future] = None
        # the occupant's stream callback (from admission to release), and
        # when its last token surfaced (the inter-token gap's start)
        self.on_token: Optional[Any] = None
        self.t_last: Optional[float] = None
        self.tokens: List[int] = []
        self.true_len = 0
        self.n_new = 0          # tokens the HOST has processed (drain side)
        self.max_new = 0
        # pipelining state: gen disambiguates a slot reused between a step's
        # dispatch and its drain; disp_new is the DISPATCH-side token count
        self.gen = 0
        self.disp_new = 0
        # the OWNED page ids (host mirror of the owned tail of the slot's
        # block-table row: freed, or adopted by the radix trie, at release),
        # the SHARED trie pages the row leads with (a prefix hit: pinned at
        # admission, unpinned at release, never written by this slot), the
        # truncated prompt (inserted into the trie at completion), whether a
        # chunked prefill is mid-flight for it, and its admission sequence
        # number (newest admitted sheds first on page exhaustion)
        self.pages: List[int] = []
        self.shared: List[int] = []
        self.ids: Optional[List[int]] = None
        self.prefilling = False
        self.admit_seq = 0

    def covered_pages(self) -> int:
        """Block-table entries pointing at real pages (shared + owned)."""
        return len(self.shared) + len(self.pages)

    # the n-th generated token sits at position true_len + n - 1
    def host_pos(self) -> int:
        return self.true_len + self.n_new - 1

    def dispatched_pos(self) -> int:
        return self.true_len + self.disp_new - 1


class _InFlight:
    """One dispatch of k decode steps the host has not yet drained: its
    tokens [S, k] (a pinned host buffer being filled by an async copy on a
    card), the event that marks the copy done, k, the per-slot (index, gen)
    snapshot taken at dispatch, and the dispatch timestamp. A spec step's
    record has k = 1, tokens [S, K+2] (the tokens, then the advance) and
    ``booked``: slot -> the tokens its dispatch booked (cap + 1)."""

    __slots__ = ("tokens", "event", "k", "snapshot", "t_dispatch", "booked")

    def __init__(self, tokens, event, k, snapshot, t_dispatch, booked=None):
        self.tokens = tokens
        self.event = event
        self.k = k
        self.snapshot = snapshot
        self.t_dispatch = t_dispatch
        self.booked = booked


class ContinuousBatcher:
    def __init__(
        self,
        server: LLMServer,
        max_slots: int = 4,
        max_len: Optional[int] = None,
        len_buckets: Optional[Sequence[int]] = None,
        pipeline_depth: Optional[int] = None,
        fuse_steps: Optional[int] = None,
        layout: Optional[str] = None,
        page_size: Optional[int] = None,
        pool_pages: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        spec_mode: Optional[str] = None,
        spec_k: Optional[int] = None,
        disaggregation: Optional[str] = None,
        disagg_mesh: Optional[DisaggregatedMesh] = None,
        prefill_workers: Optional[int] = None,
        handoff_transport: Optional[str] = None,
        tracing: Optional[bool] = None,
        device: Optional[str] = None,
        _eager: bool = False,
    ):
        """``fuse_steps`` (default: the server's ``decode_fuse_steps``; 0 or
        1 = single steps) is K, the steps one dispatch runs. ``spec_mode``
        and ``spec_k`` (default: the server's; K = 0 means 4) turn each
        dispatch into one speculative draft + verify step (module
        docstring). On a card the decode programs (K = 1 and K =
        ``fuse_steps``, or in spec mode the spec step), a prefill-chunk
        program per chunk length an admission can produce
        (``_chunk_lengths``) and, with the prefix cache on, the CoW page
        copy are captured here as CUDA graphs, before any request;
        ``_eager=True`` runs them eagerly instead (a private switch for
        comparing the two). ``disaggregation``, ``disagg_mesh``,
        ``prefill_workers`` and ``handoff_transport`` (default: the
        server's) turn admission remote (module docstring); the workers are
        built, their graphs captured, before this returns. ``tracing``
        (default: the tracer's ``enabled``) builds the flight recorder."""
        self.device = resolve_device(device)
        server.load()
        if server.device != self.device:
            raise ValueError(f"batcher device {self.device} != server device {server.device}")
        if layout is None:
            layout = getattr(server, "kv_cache_layout", "paged")
        # the KV layout (module docstring): the paged pool, or the dense
        # slot pool (one row of max_len positions a slot, one-shot admission)
        self.layout = normalize_kv_cache_layout(layout)
        self.paged = self.layout == "paged"
        mesh = getattr(server, "mesh", None)
        self.server = server
        self.S = int(max_slots)
        # over a mesh (module docstring, "Meshes"): the slots split into
        # one contiguous block a 'data' rank, a sequence's pages round robin
        # over the 'seq' ranks, one page pool a (data, seq) pair
        self._dp = mesh.axis_size("data") if mesh is not None else 1
        self._sp = mesh.axis_size("seq") if mesh is not None else 1
        if self.S % self._dp:
            raise ValueError(f"max_slots={self.S} does not split over the mesh's {self._dp} "
                             f"'data' ranks: each owns an equal block of slots")
        cfg = server._cfg
        self.len_buckets = tuple(len_buckets or server.len_buckets)
        if max_len is not None and int(max_len) <= 0:
            max_len = None
        if max_len is None:
            # sized to what serving admits: prompts bucket to len_buckets with
            # one round-up step past the top bucket, plus decode headroom
            max_len = min(2 * max(self.len_buckets), cfg.max_seq_len) + max(
                int(server.max_new_tokens), 1)
        self.max_len = int(max_len)
        self.eos_id = server.eos_id
        depth = pipeline_depth if pipeline_depth is not None else server.decode_pipeline_depth
        self.pipeline_depth = max(int(depth), 1)
        fuse = fuse_steps if fuse_steps is not None else server.decode_fuse_steps
        self.fuse_steps = max(int(fuse), 0)
        # speculative decoding, resolved from the server unless overridden;
        # the per-slot controller adapts the offered draft length to what
        # each slot's text accepts
        mode = spec_mode if spec_mode is not None else server.spec_mode
        self.spec_mode = normalize_spec_mode(mode)
        k = spec_k if spec_k is not None else server.spec_k
        self.spec_k = int(k or 0) or DEFAULT_SPEC_K
        self._spec: Optional[SpecController] = None
        if self.spec_mode != "off":
            if self.fuse_steps > 1:
                raise ValueError(
                    f"decode_fuse_steps={self.fuse_steps} cannot combine with "
                    f"spec_mode={self.spec_mode!r}: a fused dispatch runs a FIXED K steps "
                    f"while a verify step advances each slot by a data-dependent "
                    f"1..{self.spec_k + 1} tokens; run speculation with decode_fuse_steps=0 "
                    f"(pipelining composes fine)")
            if self.spec_k < 1:
                raise ValueError(f"spec_k={self.spec_k} must be >= 1 when speculation is on")
            if self.spec_mode == "draft" and server._draft_module is None:
                raise ValueError("spec_mode='draft' needs the server loaded with a draft "
                                 "model (draft_model=)")
            self._spec = SpecController(self.S, self.spec_k)
        # the dense layout has no pages, chunks, allocator or trie: its
        # slots pre-reserve whole rows (the JAX package keeps no
        # batcher-side prefix reuse for it, even with prefix_cache_size > 0)
        self.page_size = self.n_pages = self.pool_pages = self.prefill_chunk = 0
        self._allocator: Optional[PageAllocator] = None
        self._radix = None
        if self.paged:
            self._paged_pool(server, page_size, pool_pages, prefill_chunk)

        self._slots = [_Slot() for _ in range(self.S)]
        # weighted-fair admission over SLO classes and tenants, with the
        # server's weights and quotas (runtime/scheduler.py)
        self._pending = WeightedFairScheduler(
            class_weights=server.slo_class_weights, tenant_weights=server.tenant_weights,
            tenant_quota=server.tenant_quota, tenant_quotas=server.tenant_quotas)
        # the server's LoRA adapter pool, or None (the programs are then the
        # unadapted ones)
        self._adapters = server.adapter_registry
        self._prefill: Optional[_PrefillJob] = None
        self._admit_seq = 0
        self._inflight: deque = deque()
        self._inflight_hwm = 0
        self._last_admit_inflight = 0
        self._last_drain_t: Optional[float] = None
        # disaggregated prefill (module docstring), resolved from the server
        # unless overridden; the worker pool, its queue and (network
        # transport) the receiver are built after the decode graphs
        disagg = disaggregation if disaggregation is not None else server.disaggregation
        self.disaggregation = normalize_disaggregation(disagg)
        if self.disaggregation != "off" and mesh is not None:
            raise ValueError("disaggregation='remote_prefill' does not yet compose with a mesh "
                             "(ROADMAP Queue A 9b)")
        ht = (handoff_transport if handoff_transport is not None
              else server.handoff_transport) or "device"
        if ht not in HANDOFF_TRANSPORTS:
            raise ValueError(f"unknown handoff_transport {ht!r}: expected one of "
                             f"{HANDOFF_TRANSPORTS}")
        self.handoff_transport = ht
        self.disagg_mesh: Optional[DisaggregatedMesh] = None
        self._remote: Optional[PrefillWorkerPool] = None
        # the devices an explicit mesh offers (None: workers share this
        # device); and the lock that makes a submit to the pool and a
        # pool swap (rebalance_disagg) exclude each other
        self._mesh_devices: Optional[List[torch.device]] = None
        self._remote_lock = threading.Lock()
        # the scale-down mark (drain / resume): advisory, admission goes on
        self.draining = False
        self._transfer = None
        self._receiver: Optional[HandoffReceiver] = None
        self._remote_jobs: Dict[int, _RemoteJob] = {}
        self._job_seq = 0
        self._wakeup = threading.Event()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._thread_lock = threading.Lock()
        # the health view a replica fleet reads (module docstring): the
        # heartbeat each loop turn stamps on ``clock``, the exception a dead
        # loop parked, and the fault hook called after each stamp; _broken
        # is set when the crash path's wait on the stream failed
        self.clock = time.monotonic
        self.heartbeat: float = self.clock()
        self.crashed: Optional[BaseException] = None
        self._chaos: Optional[Any] = None
        self._broken: Optional[BaseException] = None
        # the flight recorder (module docstring), only with tracing on; the
        # tail thresholds from the environment
        self._tracer = get_tracer()
        self._flight: Optional[FlightRecorder] = None
        if self._tracer.enabled if tracing is None else bool(tracing):
            tail_ttft_s, tail_gap_s = tail_thresholds()
            self._flight = FlightRecorder(self.S, tail_ttft_s=tail_ttft_s, tail_gap_s=tail_gap_s)

        dev = self.device
        if self.paged:
            self._caches = server._module.init_caches(
                (self.pool_pages, self.page_size), server.kv_cache_dtype, device=dev, paged=True)
        else:
            # the dense slot pool: a row of max_len positions a slot, then a
            # trash column for the writes the JAX package drops
            # (``transformer.SlotCaches``); admission prefills a row in place
            self._caches = server._module.init_slot_caches(self.S, self.max_len,
                                                           server.kv_cache_dtype, device=dev)
        # the pool's bytes: what a decode step's attention may read at most
        # (``kv_bytes_per_step``, set at each drain as the JAX package does)
        self._cache_nbytes = sum(t.numel() * t.element_size()
                                 for layer in self._caches for t in layer)
        # Block table (paged), one row per slot, all-TRASH while a slot is
        # free so the ride-along decode writes of inactive slots land in the
        # trash page; rows switch to real pages at activation and back at
        # release. The dense layout's free slots write their own rows (each
        # admission resets its row), past the row its trash column.
        self._block_tables: Optional[torch.Tensor] = None
        if self.paged:
            self._block_tables = torch.full((self.S, self.n_pages), TRASH_PAGE,
                                            dtype=torch.int32, device=dev)
        # device-resident per-slot decode state, threaded through every step
        self._last_tok = torch.zeros((self.S,), dtype=torch.int64, device=dev)
        self._next_pos = torch.zeros((self.S,), dtype=torch.int32, device=dev)
        self._keys = torch.zeros((self.S,), dtype=torch.int64, device=dev)
        self._rng = seed_key(server.seed)
        # fixed for the batcher's life: greedy (None) picks the argmax alone;
        # a positive temperature is a 0-dim tensor on the device, as
        # generate() passes it: the same division, so the same seed draws
        # the same tokens on both paths (``sample_tokens``)
        self._temp = (torch.full((), float(server.temperature), dtype=torch.float32, device=dev)
                      if float(server.temperature) > 0 else None)
        # the prefill chunk's fixed inputs (paged): the admitted job's
        # block-table row, and its chunk's tokens and positions (a chunk of
        # C uses the first C columns); the CoW copy's (source page,
        # destination page, valid tokens), staged by the host in stream
        # order before each copy
        self._chunks: Tuple[int, ...] = ()
        self._row = self._chunk_tokens = self._chunk_pos = self._cow_args = None
        if self.paged:
            self._chunks = self._chunk_lengths()
            cmax = max(self._chunks)
            self._row = torch.full((1, self.n_pages), NULL_PAGE, dtype=torch.int32, device=dev)
            self._chunk_tokens = torch.zeros((1, cmax), dtype=torch.int64, device=dev)
            self._chunk_pos = torch.full((1, cmax), PAD_POS, dtype=torch.int32, device=dev)
            self._cow_args = torch.zeros((3,), dtype=torch.int64, device=dev)
        # the adapted programs' fixed inputs: each slot's adapter id (0 =
        # the identity; written at commit, reset at release) and the staged
        # prefill job's id (written when the job is staged; the dense
        # admission's, before its prefill)
        self._adapter_ids: Optional[torch.Tensor] = None
        self._chunk_adapter: Optional[torch.Tensor] = None
        if self._adapters is not None:
            self._adapter_ids = torch.zeros((self.S,), dtype=torch.int64, device=dev)
            self._chunk_adapter = torch.zeros((1,), dtype=torch.int64, device=dev)
        # speculation's device state: each slot's prompt + generated tokens
        # by position (one entry a cache position, plus a trash column for
        # the writes the JAX package drops), the fixed per-dispatch cap
        # buffer, and in draft mode the draft model's DENSE cache [S, max_len
        # + 1] (its last column the trash column): the draft is small, so
        # paging it would buy nothing and cost a second allocator
        self.hist_len = self.max_len
        self._hist: Optional[torch.Tensor] = None
        self._draft_cap: Optional[torch.Tensor] = None
        self._draft_caches = None
        if self.spec_mode != "off":
            self._hist = torch.zeros((self.S, self.hist_len + 1), dtype=torch.int64, device=dev)
            self._draft_cap = torch.zeros((self.S,), dtype=torch.int32, device=dev)
            if self.spec_mode == "draft":
                self._draft_caches = init_kv_caches(server._draft_cfg, self.S,
                                                    self.max_len + 1, device=dev)
        # k -> the captured K-step program, chunk length -> the captured
        # prefill chunk, the captured spec step (the card's only paths);
        # empty / None where the programs run eagerly (the CPU, or _eager)
        self._graphs: Dict[int, ReplayGraph] = {}
        self._prefill_graphs: Dict[int, ReplayGraph] = {}
        self._spec_graph: Optional[ReplayGraph] = None
        self._cow_graph: Optional[ReplayGraph] = None
        if self.device.type == "cuda" and not _eager:
            # with disaggregation on, local prefill never runs: the workers
            # capture the chunk graphs instead; the dense admission prefill
            # stays eager (a graph a length bucket would pin its float32
            # transients)
            if self.disaggregation == "off" and self.paged:
                self._prefill_graphs = capture_prefill_chunks(
                    server, self._chunks, self._caches, self._row, self._chunk_tokens,
                    self._chunk_pos, lora=self._lora(self._chunk_adapter))
            if self._radix is not None:
                self._cow_graph = capture_cow_copy(server, self._caches, self._cow_args)
            if self.spec_mode != "off":
                self._spec_graph = capture_spec_step(
                    server, self.spec_k, self.spec_mode, self._caches, self._last_tok,
                    self._next_pos, self._keys, self._temp, self._block_tables, self._hist,
                    self._draft_cap, self._draft_caches, lora=self._lora(self._adapter_ids))
            else:
                ks = (1, self.fuse_steps) if self.fuse_steps > 1 else (1,)
                self._graphs = capture_decode_steps(server, ks, self._caches, self._last_tok,
                                                    self._next_pos, self._keys, self._temp,
                                                    self._block_tables,
                                                    lora=self._lora(self._adapter_ids))
        if self.disaggregation != "off":
            self._build_remote(disagg_mesh, prefill_workers)

    def _paged_pool(self, server: LLMServer, page_size: Optional[int],
                    pool_pages: Optional[int], prefill_chunk: Optional[int]) -> None:
        """The paged layout's page size, pool, prefill chunk, allocator and
        (when the server opts in) radix prefix cache."""
        ps = int(page_size if page_size is not None else server.kv_page_size or 0) \
            or DEFAULT_PAGE_SIZE
        if ps <= 0:
            raise ValueError(f"kv_page_size={ps} must be positive")
        self.page_size = ps
        self.n_pages = -(-self.max_len // ps)   # pages per slot
        pool = int(pool_pages if pool_pages is not None else server.kv_pool_pages or 0)
        # 0 = fully provisioned (never sheds on pages); smaller pools
        # oversubscribe. Over a mesh the pages past the reserved ones split
        # evenly into the (data, seq) pools: one id space, pool_pages ids
        n_pools = self._dp * self._sp
        per_seq = -(-self.n_pages // self._sp)   # a sequence's pages on one seq rank, at most
        cap = ((pool - RESERVED_PAGES) // n_pools if pool
               else self.S // self._dp * per_seq)
        self.pool_pages = RESERVED_PAGES + n_pools * cap
        if cap < per_seq:
            raise ValueError(
                f"kv_pool_pages={pool or self.pool_pages} cannot hold even one "
                f"max_len sequence ({self.n_pages} pages of {ps} tokens "
                f"+ {RESERVED_PAGES} reserved"
                + (f", over {n_pools} (data, seq) pools" if n_pools > 1 else "") + ")")
        chunk = int(prefill_chunk if prefill_chunk is not None else server.prefill_chunk or 0)
        self.prefill_chunk = chunk or DEFAULT_PREFILL_CHUNK
        self._allocator = PageAllocator(self.pool_pages, ps, n_pools)
        # the radix prefix cache over the pool, when the server opts in: a
        # hit costs block-table entries (and one CoW page copy for a partial
        # block), not a prefill. One trie a 'data' rank, over its own pools
        if int(server.prefix_cache_size) > 0:
            bpb = ps * kv_cache_bytes_per_token(server._cfg, server.kv_cache_dtype)
            tries = [RadixPrefixCache(
                self._allocator if n_pools == 1 else
                PoolView(self._allocator, range(d * self._sp, (d + 1) * self._sp)),
                ps, bytes_per_block=bpb) for d in range(self._dp)]
            self._radix = tries[0] if self._dp == 1 else RankedPrefixCache(tries)

    def _lora(self, ids: Optional[torch.Tensor]) -> dict:
        """The adapted programs' extra arguments: ``adapters`` (the pool)
        and ``adapter_ids`` (``ids``, one of the fixed id buffers); empty
        without an adapter pool."""
        if self._adapters is None:
            return {}
        return {"adapters": self._adapters.pool(), "adapter_ids": ids}

    # ------------------------------------------------------------------
    # Disaggregated prefill: the worker pool, the import, the stats
    # ------------------------------------------------------------------
    def _build_remote(self, disagg_mesh: Optional[DisaggregatedMesh],
                      prefill_workers: Optional[int]) -> None:
        """The device split and the prefill-worker pool, publishing into one
        TransferQueue whose ``on_ready`` wakes the loop (with the network
        transport, through a HandoffReceiver on 127.0.0.1). The decode
        devices must hold this batcher's device (its pool lives there).
        Without a mesh, ``prefill_devices`` (at least 1) workers share this
        device, and the decode slice is ``decode_devices`` (at least 1)
        entries of it. A decode slice of several devices decodes on this
        batcher's one, as the JAX batcher decodes on the default device
        inside its slice; the scaling snapshot counts the slice. On a card
        every worker captures its chunk graphs, whatever ``_eager`` says:
        the private switch covers this batcher's own programs only."""
        server = self.server
        mesh = disagg_mesh if disagg_mesh is not None else server.disagg_mesh
        if mesh is None:
            mesh = DisaggregatedMesh([self.device] * (server.prefill_devices or 1),
                                     [self.device] * (server.decode_devices or 1), shared=True)
        if not any(same_device(d, self.device) for d in mesh.decode_devices):
            raise ValueError(f"the decode slice must contain the server's device ({self.device}): "
                             f"the batcher's slot pool lives there — put the PREFILL slice on the "
                             f"other devices")
        if disagg_mesh is not None or server.disagg_mesh is not None:
            self._mesh_devices = list(mesh.prefill_devices)
        n_workers = (prefill_workers if prefill_workers is not None
                     else server.prefill_workers) or len(mesh.prefill_devices)
        devices = [mesh.prefill_devices[i % len(mesh.prefill_devices)]
                   for i in range(int(n_workers))]
        # one entry a worker: the snapshot's prefill_devices is the count
        self.disagg_mesh = DisaggregatedMesh(devices, mesh.decode_devices, shared=True)
        queue = TransferQueue()
        queue.on_ready = self._wakeup.set
        receiver_addr = None
        if self.handoff_transport == "network":
            self._receiver = HandoffReceiver(queue, self.device)
            receiver_addr = self._receiver.addr
        try:
            self._remote = PrefillWorkerPool(
                server, devices, self.device, layout=self.layout, max_len=self.max_len,
                page_size=self.page_size, n_pages=self.n_pages,
                prefill_chunk=self.prefill_chunk, chunks=self._chunks, queue=queue,
                transport=self.handoff_transport, receiver_addr=receiver_addr)
        except BaseException:
            if self._receiver is not None:
                self._receiver.close()
            raise
        self._transfer = queue

    def max_prefill_workers(self) -> int:
        """The ceiling of ``rebalance_disagg``: the batcher's slot count (a
        staged job holds a decode slot, so more workers than slots are idle
        by construction), and with an explicit mesh also its number of
        prefill devices (one worker an entry)."""
        if self._mesh_devices is None:
            return self.S
        return min(self.S, len(self._mesh_devices))

    def rebalance_disagg(self, prefill_devices: int) -> bool:
        """Move to ``prefill_devices`` prefill workers: the autoscaler's
        device actuator (``controlplane/autoscaler.py``), the JAX package's
        ``rebalance_disagg``. On one card the workers share the server's
        device, so the count changes and the decode side stays this
        batcher's one device.

        Returns False, changing nothing, when disaggregation is off, the
        count is below 1 or equal to the current one, or above
        ``max_prefill_workers()``: the slot count on one card, and with an
        explicit ``disagg_mesh`` also its number of prefill devices (one
        worker an entry, the first N entries).

        The swap: the new ``PrefillWorkerPool`` is built first, each worker
        with its stream, staging pool and (on a card) chunk graphs captured
        on its own thread while this batcher goes on replaying; a build
        that fails closes what it built and raises, and the old pool keeps
        serving. Then, under ``_remote_lock``, new admissions turn to the
        new pool, which publishes into the same ``TransferQueue``; the old
        pool's ``close()`` lets each worker finish its staged jobs before
        its thread joins, waits on its stream and drops its graphs, staging
        pool and buffers, so a handed-off job is never dropped and the
        old pool's memory is free once it returns."""
        if self._remote is None:
            return False
        n = int(prefill_devices)
        if n < 1 or n == len(self._remote.workers) or n > self.max_prefill_workers():
            return False
        devices = (self._mesh_devices[:n] if self._mesh_devices is not None
                   else [self.device] * n)
        old = self._remote
        new_pool = PrefillWorkerPool(
            self.server, devices, self.device, layout=self.layout, max_len=self.max_len,
            page_size=self.page_size, n_pages=self.n_pages, prefill_chunk=self.prefill_chunk,
            chunks=self._chunks, queue=self._transfer, transport=old.transport,
            receiver_addr=old.receiver_addr)
        with self._remote_lock:
            self._remote = new_pool
            self.disagg_mesh = DisaggregatedMesh(devices, self.disagg_mesh.decode_devices,
                                                 shared=True)
        old.close()
        logger.info("rebalanced the prefill workers from %d to %d", len(old.workers), n)
        return True

    def drain(self) -> None:
        """Mark this batcher draining (a fleet's scale-down): advisory only.
        Admission goes on, so nothing routed here fails; the fleet stops
        dispatching to the replica and the scaling snapshot reports it."""
        self.draining = True

    def resume(self) -> None:
        """Cancel a drain: the warm batcher rejoins fleet dispatch."""
        self.draining = False

    def handoff_stats(self) -> dict:
        """Handoffs delivered, their bytes, the jobs staged or ready, and the
        bytes the network receiver took in; all-off zeros without
        disaggregation."""
        if self._remote is None:
            return {"disaggregation": "off", "handoffs_total": 0,
                    "handoff_transfer_bytes_total": 0, "handoff_queue_depth": 0,
                    "handoff_network_bytes_total": 0}
        total, nbytes, depth = self._transfer.stats()
        net = (self._receiver.stats()["handoff_network_bytes_total"]
               if self._receiver is not None else 0)
        return {"disaggregation": self.disaggregation, "handoffs_total": total,
                "handoff_transfer_bytes_total": nbytes, "handoff_queue_depth": depth,
                "handoff_network_bytes_total": net}

    def _get_handoff_import(self, staged_pages: Optional[int] = None):
        """The server's import of a bucket of ``staged_pages`` pages into
        this batcher's pool (``LLMServer._get_handoff_import``)."""
        return self.server._get_handoff_import(self.n_pages, staged_pages)

    def _export_pages(self, pages: List[int]):
        """The pool's ``pages`` as a handoff-shaped bucket (RESERVED_PAGES
        leading rows, then the pages, TRASH padding to a power of two), a
        gather on this stream, and the event recorded after it (None on the
        CPU). The pool itself is untouched."""
        b = pow2_bucket(len(pages), self.n_pages)
        idx = np.full((RESERVED_PAGES + b,), TRASH_PAGE, np.int64)
        idx[RESERVED_PAGES:RESERVED_PAGES + len(pages)] = pages
        idx_t = self._to_device(idx)
        bucket = [tuple(t.index_select(0, idx_t) for t in layer) for layer in self._caches]
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return bucket, event

    # ------------------------------------------------------------------
    # Host <-> device staging
    # ------------------------------------------------------------------
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A small host array on the device without stalling the stream:
        a pinned copy moves asynchronously, in stream order. Each call pins
        a fresh host copy, which the pinned allocator keeps until its copy
        has run: a reused staging buffer could be overwritten while its
        copy still waits behind in-flight replays."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _stage_to_host(self, t: torch.Tensor):
        """(host tensor, event): an async copy of ``t`` into pinned memory
        enqueued right behind the step that produced it, and the event that
        marks it done. On the CPU the tensor is already the host copy."""
        if t.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    # ------------------------------------------------------------------
    def retry_after_hint(self) -> float:
        """``Retry-After`` for shed responses from the live backlog: the
        drain capacity is S slots per wave, so ``base x ceil(queued / S)``,
        doubled near page-pool exhaustion (paged), clamped to [base, 30 s]."""
        base = float(DEFAULT_RETRY_AFTER_S)
        queued = len(self._pending)
        queued += sum(1 for s in self._slots if s.active or s.prefilling)
        hint = base * max(-(-queued // max(self.S, 1)), 1)
        if self.paged:
            total, in_use, _ = self._allocator.stats()
            if in_use / max(total - RESERVED_PAGES, 1) >= 0.9:
                hint *= 2
        return float(min(max(hint, base), max(30.0, base)))

    def page_stats(self, radix_stats: Optional[dict] = None) -> dict:
        """Pool gauges: total and in-use pages, page size, sheds so far, and
        internal fragmentation (1 - tokens written / page tokens held).
        Each page's tokens count once: slots count their OWNED pages'
        tokens, trie blocks (shared ones included) count whole, from
        ``radix_stats`` (a ``RadixPrefixCache.stats()`` snapshot, to spare
        a second trie walk a scrape) or a fresh walk. All zeros under the
        dense layout (no pool exists)."""
        if not self.paged:
            return {"kv_pages_total": 0, "kv_pages_in_use": 0, "kv_page_size": 0,
                    "kv_page_fragmentation": 0.0, "kv_page_sheds": 0}
        total, in_use, sheds = self._allocator.stats()
        ps = self.page_size
        used = 0
        for s in self._slots:
            if s.active:
                used += min(max(s.true_len + s.disp_new - len(s.shared) * ps, 0),
                            len(s.pages) * ps)
        job = self._prefill
        if job is not None:
            jslot = self._slots[job.slot]
            used += min(max(job.next - len(jslot.shared) * ps, 0), len(jslot.pages) * ps)
        if self._radix is not None:
            rs = radix_stats if radix_stats is not None else self._radix.stats()
            used += rs["prefix_cached_blocks"] * ps
        frag = 1.0 - used / float(in_use * ps) if in_use > 0 else 0.0
        return {"kv_pages_total": total, "kv_pages_in_use": in_use,
                "kv_page_size": ps, "kv_page_fragmentation": max(0.0, min(1.0, frag)),
                "kv_page_sheds": sheds}

    # ------------------------------------------------------------------
    def submit(self, prompt: Any, max_new_tokens: Optional[int] = None,
               seed: Optional[int] = None, info: Optional[dict] = None,
               on_token: Optional[Any] = None, tenant: Optional[str] = None,
               slo_class: Optional[str] = None, adapter: Optional[str] = None,
               deadline_s: Optional[float] = None, resume_tokens: int = 0,
               trace: Optional[Any] = None) -> Future:
        """prompt: str or token sequence. Returns a Future of the generated
        token ids. ``seed`` pins the request's sampling chain to
        ``generate(..., seed=seed)``'s. ``resume_tokens`` > 0 marks a
        fleet resume: ``prompt`` holds the original prompt and the tokens
        already delivered, and a seeded sampled request draws its first
        token ``resume_tokens`` splits down the chain (``_first_key``), so
        it continues the interrupted generation. ``info`` is filled at admission with
        a ``truncated_prompt`` record when the slot cache cuts the prompt.
        ``on_token`` (optional) is called from the loop thread with each
        token as it surfaces and with None once at the end; it should only
        hand the token on (a queue put).

        ``tenant`` names the traffic's owner, ``slo_class`` its class
        ("interactive", the default, or "batch"; an unknown class raises
        SeldonError 400), ``adapter`` a loaded LoRA adapter (unknown, or
        given to a server without a pool: 400; resolved and pinned here, so
        it cannot be evicted while the request is queued or decoding) and
        ``deadline_s`` a latency budget that orders the request earliest
        deadline first within its tenant. A tenant over its quota is shed
        here: ShedError (503) with the backlog's Retry-After. ``trace`` (a
        ``tracing.TraceContext``) roots the request's timeline in its
        ingress's trace; with the recorder on, a request without one is
        recorded under a fresh trace id; off, it is ignored."""
        if self._closed:
            raise ShedError("batcher closed; retry")
        if isinstance(prompt, str):
            ids = self.server._tokenizer.encode(prompt)
        else:
            ids = [int(t) for t in np.asarray(prompt).ravel()]
        if not ids:
            raise ValueError("empty prompt")
        try:
            cls = normalize_slo_class(slo_class)
        except ValueError as e:
            raise SeldonError(str(e), status_code=400)
        aid = 0
        if adapter:
            if self._adapters is None:
                raise SeldonError(f"adapter {adapter!r} requested but the server has no "
                                  f"adapter pool (set lora_rank > 0)", status_code=400)
            # resolved and pinned at once, from the moment the request
            # exists: unpinned exactly once, at its shed while queued or
            # staged (_unpin_request), or at its slot's release
            try:
                aid = self._adapters.resolve_and_pin(adapter)
            except KeyError as e:
                raise SeldonError(str(e.args[0]), status_code=400)
        now = time.perf_counter()
        fut: Future = Future()
        req = PendingRequest(
            ids=ids, max_new=int(max_new_tokens or self.server.max_new_tokens), fut=fut,
            on_token=on_token, info=info, seed=seed, t_arrival=now, trace=trace,
            tenant=str(tenant or ""),
            slo_class=cls, adapter_id=aid,
            deadline_t=(now + float(deadline_s)) if deadline_s is not None else None,
            resume_tokens=int(resume_tokens or 0))
        if not self._pending.push(req):
            # the tenant is over its queued-request quota (the scheduler
            # counted the shed against it)
            if aid:
                self._adapters.unpin(aid)
            raise ShedError(f"tenant {req.tenant!r} over its admission quota",
                            retry_after_s=self.retry_after_hint())
        self._ensure_running()
        self._wakeup.set()
        return fut

    def accommodates(self, prompt: Any, max_new_tokens: Optional[int] = None) -> bool:
        """True when this batcher decodes the request exactly as a private
        ``generate()`` call would: no extra prompt truncation, and the
        token budget fits behind the prompt in the slot cache."""
        if isinstance(prompt, str):
            n = len(self.server._tokenizer.encode(prompt))
        else:
            n = int(np.asarray(prompt).size)
        plen = min(bucket(n, self.len_buckets), self._plen_cap())
        max_new = int(max_new_tokens or self.server.max_new_tokens)
        return n <= plen and max_new <= self.max_len - n

    def _ensure_running(self):
        with self._thread_lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, name="batcher-loop",
                                                daemon=True)
                self._thread.start()

    def close(self, timeout_s: float = 30.0) -> None:
        self._closed = True
        self._wakeup.set()
        with self._thread_lock:
            thread = self._thread
        if thread is not None:
            thread.join(timeout_s)
            if thread.is_alive():
                raise RuntimeError("batcher loop did not stop within "
                                   f"{timeout_s}s")
        # the workers first (bounded joins): their last frames land before
        # the receiver's listener goes
        if self._remote is not None:
            self._remote.close(timeout_s)
        if self._receiver is not None:
            self._receiver.close()

    # ------------------------------------------------------------------
    def _plen_cap(self) -> int:
        """The longest prompt a slot admits: the model's context, less one
        position of the slot cache for a generated token."""
        return min(self.server._cfg.max_seq_len, self.max_len - 1)

    def _chunk_lengths(self) -> Tuple[int, ...]:
        """Every chunk length an admission can produce: ``min(prefill_chunk,
        plen)`` over every plen ``_truncate_prompt`` returns. A plen is a
        bucket of ``len_buckets`` or, past the top bucket, a multiple of
        it, clipped to ``_plen_cap``; every plen past ``min(prefill_chunk,
        cap)`` gives that same chunk."""
        longest = min(self.prefill_chunk, self._plen_cap())
        top = self.len_buckets[-1]
        plens = [*self.len_buckets, *(top * m for m in range(2, -(-longest // top) + 1))]
        return tuple(sorted({min(p, longest) for p in plens}))

    def _truncate_prompt(self, ids: List[int], max_new: int, info: Optional[dict]):
        """Admission clipping: never beyond the model's context, and leave
        room for at least one generated token. Returns (ids, plen bucket)."""
        plen = min(bucket(len(ids), self.len_buckets), self._plen_cap())
        if len(ids) > plen:
            if info is not None:
                info["truncated_prompt"] = {"prompt_tokens": len(ids),
                                            "kept_tokens": plen,
                                            "max_len": self.max_len}
            logger.warning("batcher truncating %d-token prompt to its last %d tokens "
                           "(slot cache max_len=%d)", len(ids), plen, self.max_len)
        return ids[-plen:], plen

    def _first_key(self, seed: Optional[int], resume_tokens: int = 0) -> int:
        """A request's first-token key on generate()'s chain:
        ``seed_key(seed)`` for a seeded request, else a fresh key split off
        the batcher's own chain (in admission order: at activation for a
        local prefill, at staging for a remote one). A seeded, sampled
        resume after ``resume_tokens`` delivered tokens starts where the
        interrupted slot's chain stood (``fast_forward_key``), so the token
        drawn here is that generation's next one. Greedy needs no
        fast-forward: its pick ignores the key. Local and remote admission
        both take their key here."""
        if seed is not None:
            if resume_tokens > 0 and self._temp is not None:
                return fast_forward_key(seed, resume_tokens)
            return seed_key(seed)
        self._rng, key = split_keys(self._rng)
        return key

    def _sample_first(self, first_logits: torch.Tensor, seed: Optional[int],
                      resume_tokens: int = 0):
        """First token from the prefill logits (``first_token``). Returns
        (token, next key) as host ints — one sync per admission, not per
        token."""
        return first_token(first_logits, self._first_key(seed, resume_tokens), self._temp,
                           self.server.top_k)

    def _commit_slot(self, i: int, first: int, key: int, ids: List[int], req: PendingRequest):
        """Thread the new occupant's state into the device arrays and
        surface the first token; its tenant, class and adapter id (the pin
        moves from the request to the slot) ride the slot until release; in
        spec mode also seed the slot's history (the prompt ``ids``, then the
        first token), reset its controller and prefill its draft-cache row.
        The writes are stream-ordered after every already-dispatched step,
        so in-flight steps still see (and waste compute on) the old state
        while the next one picks up the new."""
        L = len(ids)
        max_new = req.max_new
        slot = self._slots[i]
        slot.active = True
        slot.prefilling = False
        slot.future = req.fut
        slot.true_len = L
        slot.max_new = max_new
        slot.n_new = 1
        slot.tokens = [first]
        slot.tenant = req.tenant
        slot.slo_class = req.slo_class
        slot.adapter_id = req.adapter_id
        if self._adapter_ids is not None:
            # fill_ on the element's view: a Python scalar assigned into a
            # device tensor's element would synchronise the host
            self._adapter_ids[i].fill_(slot.adapter_id)
        # the truncated prompt feeds the trie's insertion at completion
        slot.ids = list(ids)
        # the first token surfaces now: TTFT, and the start of the next
        # token's gap
        now = time.perf_counter()
        if req.t_arrival is not None:
            self.server._ttft_times.append(now - req.t_arrival)
            self.server._ttft_by_class.append((slot.slo_class, now - req.t_arrival))
        self._pending.count_tokens(slot.tenant, slot.slo_class, 1)
        slot.t_last = now
        if self._flight is not None:
            if req.resume_tokens:
                # a fleet resume: where the failover re-attached
                self._flight.record(i, EV_RESUME, tokens=req.resume_tokens)
            self._flight.record(i, EV_FIRST_TOKEN, tokens=1)
        slot.gen += 1          # invalidates in-flight tokens for the old occupant
        slot.disp_new = 1      # the prefill-sampled first token counts
        self._admit_seq += 1
        slot.admit_seq = self._admit_seq
        # dispatches in flight at the latest admission (they finish on the
        # old state first, in stream order)
        self._last_admit_inflight = len(self._inflight)
        # in place, on the decode stream (the JAX package's donated set_slot)
        self._last_tok[i] = first
        self._next_pos[i] = L
        self._keys[i] = key
        if self._spec is not None:
            # the whole row: the previous occupant's tokens are retired
            row = np.zeros((self.hist_len + 1,), np.int64)
            row[:L] = ids
            row[L] = first
            self._hist[i].copy_(self._to_device(row))
            self._spec.reset(i)
            if self._draft_caches is not None:
                self._draft_prefill_slot(i, ids)
        if first != self.eos_id:
            _emit(slot.on_token, first)
        if first == self.eos_id or max_new <= 1:
            self._finish(i)

    @staticmethod
    def _flight_tags(req: PendingRequest) -> Optional[dict]:
        """The request's tenant identity on its timeline and root span; None
        for untenanted base traffic (the single-tenant layout)."""
        if not req.tenant and req.slo_class == INTERACTIVE and not req.adapter_id:
            return None
        return {"tenant": req.tenant, "slo_class": req.slo_class, "adapter_id": req.adapter_id}

    def _draft_prefill_slot(self, i: int, ids: List[int]) -> None:
        """Draft mode: the draft model's prompt prefill into slot ``i``'s row
        of the dense draft cache (its first ``max_len`` columns), reset
        first, so the previous occupant's rows are retired. Eager: the
        draft is small. Its logits are discarded: drafting restarts from
        the last accepted target token in every spec step."""
        L = len(ids)
        plen = min(bucket(L, self.len_buckets), self._plen_cap())
        toks = np.zeros((1, plen), np.int64)
        pos = np.full((1, plen), PAD_POS, np.int32)
        toks[0, :L] = ids
        pos[0, :L] = np.arange(L)
        row = [tuple(t[i:i + 1, :self.max_len] for t in layer) for layer in self._draft_caches]
        self.server._get_draft_prefill(1, plen, self.max_len)(row, self._to_device(toks),
                                                              self._to_device(pos))

    def _reset_pages(self, pages: List[int]) -> None:
        """Position rows of newly allocated pages back to PAD_POS: a page off
        the free list still holds its previous owner's positions, which
        another sequence's mask would otherwise attend. In place, in the
        pools that hold them (``pool_ranks``)."""
        ids = self._to_device(np.asarray(pages, np.int64))
        for layers, local in self.server._module.pool_ranks(self._caches, ids):
            for layer in layers:
                layer[-1].index_fill_(0, local, PAD_POS)

    def _data_rank(self, i: int) -> int:
        """The 'data' rank owning slot ``i`` (contiguous blocks of slots)."""
        return i // (self.S // self._dp)

    def _trie(self, d: int):
        """Data rank ``d``'s prefix trie."""
        return self._radix.tries[d] if isinstance(self._radix, RankedPrefixCache) else self._radix

    def _alloc_pages(self, i: int, start: int, n: int) -> Optional[List[int]]:
        """Pages for slot ``i``'s block-table columns ``start .. start + n``,
        each from the pool its column names (the slot's data rank, seq rank
        ``column mod sp``), all or none, with radix-eviction relief: when
        the free lists cannot cover them, the slot's trie evicts
        least-recently-matched leaves no slot references before this gives
        up (cached prefixes are a cache, live slots the tenants). Shedding
        starts only where eviction ends."""
        d = self._data_rank(i)
        pools = [d * self._sp + j % self._sp for j in range(start, start + n)]
        counts = Counter(pools)
        got = self._allocator.alloc_pools(counts)
        if got is None and self._radix is not None and self._trie(d).evict(
                max(counts.values())):
            got = self._allocator.alloc_pools(counts)
        if got is None:
            return None
        return [got[p].pop(0) for p in pools]

    def _cow_copy(self, src: int, dst: int, n_valid: int) -> None:
        """Stage (src, dst, n_valid) into the fixed ``_cow_args`` buffer and
        copy the page: a replay of the CoW graph on a card, the eager
        program otherwise. In stream order, behind every step already
        enqueued and before the job's first chunk."""
        self._cow_args.copy_(self._to_device(np.asarray([src, dst, n_valid], np.int64)))
        if self._cow_graph is not None:
            self._cow_graph.replay()
            self.server._cow_replays += 1
        else:
            a = self._cow_args
            cow_page_copy(self._caches, a[0:1], a[1:2], a[2:3], self.server._module)
            self.server._cow_eager += 1

    def _free_slot(self, ids: Optional[List[int]] = None, adapter_id: int = 0) -> Optional[int]:
        """The slot an admission takes: the lowest free one; over 'data'
        ranks, the lowest free slot of the rank whose trie holds the longest
        prefix of ``ids``, then of the rank with the most free slots."""
        free = [i for i, s in enumerate(self._slots) if not s.active and not s.prefilling]
        if not free or self._dp == 1 or ids is None:
            return free[0] if free else None
        first: Dict[int, int] = {}
        n_free: Counter = Counter()
        for i in free:
            first.setdefault(self._data_rank(i), i)
            n_free[self._data_rank(i)] += 1

        def key(d):
            hit = (self._trie(d).match_len(ids)
                   if self._radix is not None and adapter_id == 0 else 0)
            return (-hit, -n_free[d], d)

        return first[min(first, key=key)]

    def _rank_busy(self, d: int) -> bool:
        """A slot of data rank ``d`` is active or prefilling (so one will
        free pages of its pools)."""
        return any((s.active or s.prefilling) and self._data_rank(i) == d
                   for i, s in enumerate(self._slots))

    def _admit_begin(self, req: PendingRequest) -> bool:
        """Paged admission, phase 1 (host side, cheap): match the prompt
        against the radix trie (shared full blocks enter the block row as
        they are; a prefix ending part-way into a cached block pays one CoW
        page copy), allocate fresh pages for the rest, reset their
        positions, and stage a chunked-prefill job over the uncached suffix
        only, from ``k0``. The match is capped at L - 1 tokens, so the last
        prompt token always prefills: its logits seed the first token (the
        trie stores pages, never logits). An adapted request neither
        matches nor (at completion) inserts. True when the request was
        CONSUMED (staged, or shed with 503); False leaves it queued."""
        if self._free_slot() is None:
            return False
        ids, plen = self._truncate_prompt(req.ids, req.max_new, req.info)
        free = self._free_slot(ids, req.adapter_id)
        d = self._data_rank(free)
        L = len(ids)
        n0 = -(-L // self.page_size)
        k0, shared, cow = 0, [], None
        if self._radix is not None and req.adapter_id == 0:
            k0, shared, cow = self._trie(d).match_and_pin(ids, limit=L - 1)
        fresh = self._alloc_pages(free, len(shared), n0 - len(shared))
        if fresh is None and cow is not None:
            # the CoW pin can be what starves the pool: its source page is
            # unevictable while pinned, so on a minimum pool eviction may
            # fall one page short. A partial-block match is an optimisation:
            # drop it (the tail prefills as a miss, the full blocks stay
            # shared) and retry, so an admission always fits an idle pool
            self._allocator.free([cow[0]])
            k0 -= cow[1]
            cow = None
            fresh = self._alloc_pages(free, len(shared), n0 - len(shared))
        if fresh is None:
            if shared:
                self._allocator.free(shared)  # drop the pins: retry later
            # an admission always fits an empty pool (prompts cap at
            # max_len-1, the pool holds >= one max_len sequence, and the
            # trie yields its unreferenced blocks first), so with nothing in
            # flight on the slot's data rank to free a page, shed now
            # instead of waiting
            if not self._rank_busy(d):
                self._shed_queued_request(
                    req, f"admission needs {n0} KV pages (pool capacity "
                         f"{self._allocator.capacity}, {self._allocator.stats()[1]} in use)")
                return True
            return False
        cow_dst = fresh[0] if cow is not None else None
        plain = fresh[1:] if cow is not None else fresh
        slot = self._slots[free]
        slot.shared = list(shared)
        slot.pages = list(fresh)
        slot.prefilling = True
        slot.future = req.fut
        slot.on_token = req.on_token
        slot.tenant = req.tenant
        slot.slo_class = req.slo_class
        if self._flight is not None:
            self._flight.begin(free, req.trace, req.t_arrival, L, tags=self._flight_tags(req))
        # shared trie pages are live cached KV and never reset; the CoW
        # destination is overwritten whole (values and masked positions)
        if plain:
            self._reset_pages(plain)
        if cow is not None:
            self._cow_copy(cow[0], cow_dst, cow[1])
            # the copy is enqueued ahead of any reuse of its source: unpin
            self._allocator.free([cow[0]])
        row = np.full((1, self.n_pages), NULL_PAGE, np.int32)
        row[0, :n0] = slot.shared + slot.pages
        # the previous job's chunks and activation read the row before this
        # write, in stream order
        self._row.copy_(self._to_device(row))
        if self._chunk_adapter is not None:
            self._chunk_adapter.fill_(req.adapter_id)
        if k0:
            # counted once per funded admission (a match that could not be
            # funded retries every loop turn)
            self._trie(d).record_hit(k0, len(shared), cow is not None)
            if self._flight is not None:
                self._flight.record(free, EV_PREFIX_HIT, tokens=k0,
                                    blocks=len(shared) + (cow is not None))
        self._prefill = _PrefillJob(free, ids, k0, min(self.prefill_chunk, plen), req)
        return True

    def _prefill_step(self):
        """One chunked-prefill dispatch: write the next ``chunk`` prompt
        tokens into the pool through the job's block-table row, a replay of
        the chunk length's graph on a card (a length without one raises),
        the eager program otherwise. Only the LAST chunk syncs (its logits
        seed the first token)."""
        job = self._prefill
        C = job.chunk
        start = job.next
        part = job.ids[start:start + C]
        n = len(part)
        toks = np.zeros((1, C), np.int64)
        pos = np.full((1, C), PAD_POS, np.int32)
        toks[0, :n] = part
        pos[0, :n] = np.arange(start, start + n)
        t0 = time.perf_counter()
        self._chunk_tokens[:, :C] = self._to_device(toks)
        self._chunk_pos[:, :C] = self._to_device(pos)
        if self._prefill_graphs:
            graph = self._prefill_graphs.get(C)
            if graph is None:
                raise RuntimeError(f"no prefill graph for a chunk of {C} tokens (captured: "
                                   f"{sorted(self._prefill_graphs)})")
            logits = graph.replay()
            self.server._prefill_replays += 1
        else:
            logits = self.server._get_prefill_chunk(C, self.n_pages, self._adapters is not None)(
                self._caches, self._row, self._chunk_tokens[:, :C], self._chunk_pos[:, :C],
                **self._lora(self._chunk_adapter))
            self.server._prefill_eager += 1
        job.next = start + n
        if self._flight is not None:
            # the host enqueue wall: the last chunk's logits sync comes after,
            # in the gap before the first_token event
            self._flight.record(job.slot, EV_PREFILL_CHUNK, start=start, tokens=n,
                                dur_s=time.perf_counter() - t0)
        if job.next >= job.L:
            self._activate(job, logits[0, n - 1])

    def _activate(self, job: _PrefillJob, first_logits: torch.Tensor):
        """Paged admission, final phase: sample the first token, point the
        slot's device block-table row at its pages (copied from the fixed
        row), commit the slot."""
        first, key = self._sample_first(first_logits, job.req.seed, job.req.resume_tokens)
        self._block_tables[job.slot].copy_(self._row[0])
        self._prefill = None
        self._commit_slot(job.slot, first, key, job.ids, job.req)

    def _admit(self, req: PendingRequest) -> bool:
        """Dense admission (the JAX package's ``_admit``): the one-shot
        prefill of the whole prompt into the free slot's row of the pool,
        in place (``_get_prefill(1, plen, max_len)``, which resets the row
        first, trash column and all, so the previous occupant's positions
        are retired; the adapted program for an adapter pool), eagerly: a
        graph a length bucket would pin its float32 transients. Stream
        order puts it after every dispatch already enqueued, which still
        write the old occupant's row. The first token is read here, one
        host sync an admission; then the slot commits. True when a slot
        was free (the request is consumed)."""
        free = self._free_slot()
        if free is None:
            return False
        ids, plen = self._truncate_prompt(req.ids, req.max_new, req.info)
        L = len(ids)
        slot = self._slots[free]
        slot.on_token = req.on_token
        if self._flight is not None:
            self._flight.begin(free, req.trace, req.t_arrival, L, tags=self._flight_tags(req))
        toks = np.zeros((1, plen), np.int64)
        pos = np.full((1, plen), PAD_POS, np.int32)
        toks[0, :L] = ids
        pos[0, :L] = np.arange(L)
        t0 = time.perf_counter()
        lora = self._adapters is not None
        if lora:
            self._chunk_adapter.fill_(req.adapter_id)
        logits = self.server._get_prefill(1, plen, self.max_len, lora)(
            self.server._module.slot_rows(self._caches, free), self._to_device(toks),
            self._to_device(pos), **self._lora(self._chunk_adapter))
        self.server._prefill_eager += 1
        first, key = self._sample_first(logits[0, L - 1], req.seed, req.resume_tokens)
        if self._flight is not None:
            self._flight.record(free, EV_PREFILL, tokens=L, dur_s=time.perf_counter() - t0)
        self._commit_slot(free, first, key, ids, req)
        return True

    # ------------------------------------------------------------------
    # Disaggregated admission: stage remote jobs, consume handoffs
    # ------------------------------------------------------------------
    def _admit_remote(self, req: PendingRequest) -> bool:
        """Remote-prefill admission, the decode side's half (host work and
        at most one page export): reserve a slot, match whole trie blocks
        only (shared into the slot's row; their KV goes to the worker as an
        exported bucket, so it computes only the suffix; capped at L - 1,
        so the worker always computes the first token's logits), allocate
        the suffix's pages, draw the first token's key and stage the job.
        True when the request was consumed (staged, or shed with 503);
        False leaves it queued."""
        free = self._free_slot()
        if free is None:
            return False
        ids, plen = self._truncate_prompt(req.ids, req.max_new, req.info)
        L = len(ids)
        n0 = -(-L // self.page_size) if self.paged else 0
        k0, shared = 0, []
        if self._radix is not None and req.adapter_id == 0:
            k0, shared, _ = self._radix.match_and_pin(ids, limit=L - 1, full_blocks_only=True)
        # the dense layout's slot holds its whole row: no pages to fund
        pages = self._alloc_pages(free, len(shared), n0 - len(shared)) if self.paged else []
        if pages is None:
            if shared:
                self._allocator.free(shared)  # drop the pins: retry later
            # a staged remote slot is prefilling: with nothing in flight
            # anywhere, nothing will free a page, so shed now
            if not any(s.active or s.prefilling for s in self._slots):
                self._shed_queued_request(
                    req, f"admission needs {n0} KV pages (pool capacity "
                         f"{self._allocator.capacity}, {self._allocator.stats()[1]} in use)")
                return True
            return False
        row = None
        if self.paged:
            row = np.full((self.n_pages,), NULL_PAGE, np.int32)
            row[:n0] = shared + pages
        prefix, prefix_event = (self._export_pages(shared) if shared else (None, None))
        slot = self._slots[free]
        slot.pages = list(pages)
        slot.shared = list(shared)
        slot.prefilling = True
        slot.future = req.fut
        slot.on_token = req.on_token
        slot.tenant = req.tenant
        slot.slo_class = req.slo_class
        self._job_seq += 1
        job = _RemoteJob(self._job_seq, free, ids, row, len(shared), req)
        self._remote_jobs[job.job_id] = job
        if k0:
            self._radix.record_hit(k0, len(shared), False)
        if self._flight is not None:
            self._flight.begin(free, req.trace, req.t_arrival, L, tags=self._flight_tags(req))
            if k0:
                self._flight.record(free, EV_PREFIX_HIT, tokens=k0, blocks=len(shared))
            self._flight.record(free, EV_HANDOFF_STAGED, job_id=job.job_id,
                                pages=n0 - len(shared))
        preq = PrefillRequest(
            job.job_id, ids, plen, n0, record_events=self._flight is not None,
            prefix_len=k0, prefix_pages=len(shared),
            prefix_staged=prefix, prefix_event=prefix_event,
            first_key=self._first_key(req.seed, req.resume_tokens))
        with self._remote_lock:  # never into a pool a rebalance is closing
            self._remote.submit(preq)
        return True

    def _import_handoff(self, job: _RemoteJob, h) -> None:
        """One handoff into the slot's pages: this stream waits for the
        event the bucket was written under (no host wait), the bucket is
        marked used on this stream (its memory is not reused before the
        import has run), the suffix pages are imported and the slot's
        block-table row written. Dense: the bucket (the prompt's columns
        of the worker's row) goes into the slot's row, reset first
        (``insert_slot_row``), the JAX package's insert."""
        if h.first_token is None or h.first_key is None:
            raise ValueError(f"handoff for job {job.job_id} carries no first token")
        staged = h.staged
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            if h.event is not None:
                stream.wait_event(h.event)
            for t in staged_leaves(staged):
                t.record_stream(stream)
        if not self.paged:
            insert_slot_row(self.server._module.slot_rows(self._caches, job.slot), staged)
            return
        n_suffix = -(-job.L // self.page_size) - job.prefix_pages
        row_suffix = np.full((self.n_pages,), NULL_PAGE, np.int64)
        row_suffix[:n_suffix] = job.row[job.prefix_pages:job.prefix_pages + n_suffix]
        self._get_handoff_import(staged[0][0].shape[0] - RESERVED_PAGES)(
            self._caches, staged, row_suffix, n_suffix)
        self._block_tables[job.slot].copy_(self._to_device(job.row))

    def _consume_handoffs(self) -> None:
        """Drain every READY handoff: import it and commit its slot as a
        local admission would, with the worker's first token. A worker's
        error, or an import that raises, fails that request alone."""
        while True:
            h = self._transfer.pop()
            if h is None:
                return
            job = self._remote_jobs.pop(h.job_id, None)
            if job is None:
                continue  # cancel removes READY records itself
            if h.error is not None:
                self._fail_remote_job(job, h.error)
                continue
            if self._flight is not None and h.events:
                # the worker's stages, stamped before it published the
                # handoff (ownership moved through the queue's lock)
                self._flight.extend(job.slot, h.events)
            t0 = time.perf_counter()
            try:
                self._import_handoff(job, h)
            except Exception as e:  # a poisoned handoff fails its request, not the batch
                logger.exception("poisoned handoff (slot %d): %s", job.slot, e)
                self._fail_remote_job(job, e)
                continue
            t1 = time.perf_counter()
            self.server._handoff_times.append(h.prefill_s + (t1 - t0))
            if self._flight is not None:
                self._flight.record(job.slot, EV_HANDOFF_IMPORT, bytes=h.transfer_bytes,
                                    dur_s=t1 - t0)
            self._commit_slot(job.slot, h.first_token, h.first_key, job.ids, job.req)

    def _fail_remote_job(self, job: _RemoteJob, exc: BaseException) -> None:
        """Release a remote job's slot and pages, then fail its request (its
        timeline completes "error", unless a shed completed it first)."""
        if self._flight is not None:
            self._flight.complete(job.slot, "error", 0, self._tracer)
        self._unpin_request(job.req)
        on_token = self._slots[job.slot].on_token
        self._release_slot(job.slot)  # before notifying, like _finish
        _emit(on_token, None)
        _resolve(job.req.fut, exc=exc)

    def _shed_remote_job(self, job_id: int, why: str) -> None:
        """Shed a staged remote admission (503): the queue's cancel makes it
        exactly once (the READY handoff leaves with its payload, or the
        worker's later put is refused), and this path alone frees its
        decode-side pages."""
        job = self._remote_jobs.pop(job_id, None)
        if job is None:
            return
        self._transfer.cancel(job_id)
        self._allocator.count_shed()
        self._pending.count_shed(job.req.tenant, job.req.slo_class)
        logger.warning("shedding staged remote prefill (slot %d): %s", job.slot, why)
        if self._flight is not None:
            self._flight.record(job.slot, EV_SHED, why=why)
            self._flight.complete(job.slot, "shed", 0, self._tracer)
        self._fail_remote_job(job, self._shed_error(why))

    def _fail_remote_jobs(self, exc: BaseException) -> None:
        """Shutdown / crash: no staged request may leave its future hanging."""
        for job_id in list(self._remote_jobs):
            job = self._remote_jobs.pop(job_id)
            self._transfer.cancel(job_id)
            self._fail_remote_job(job, exc)

    # ------------------------------------------------------------------
    # Page accounting: growth, exhaustion shedding, release
    # ------------------------------------------------------------------
    def _ensure_slot_pages(self, i: int, last_write_pos: int) -> bool:
        """Grow slot ``i``'s pages to cover writes up to ``last_write_pos``
        BEFORE the step that writes them is dispatched. On exhaustion the
        newest other tenant sheds (503); a sole tenant stops generating with
        the tokens it has. Returns False when the slot was finished/released."""
        slot = self._slots[i]
        if not slot.active:
            return False
        need = min(last_write_pos, self.max_len - 1) // self.page_size + 1
        n0_pages = slot.covered_pages()
        t0_grow = time.perf_counter() if n0_pages < need else 0.0
        while slot.covered_pages() < need:
            got = self._alloc_pages(i, slot.covered_pages(), 1)
            if got is None:
                victim = self._pick_page_victim(self._data_rank(i))
                if victim is None:
                    logger.warning("kv page pool exhausted with no shed candidate: "
                                   "slot %d ends at %d generated tokens", i, slot.n_new)
                    self._finish(i)
                    return False
                if victim == "job":
                    self._shed_prefill_job("page pool exhausted by decode")
                    continue
                if isinstance(victim, tuple):  # ("remote", job_id)
                    self._shed_remote_job(victim[1], "page pool exhausted by decode")
                    continue
                self._shed_slot(victim, "page pool exhausted")
                if victim == i:
                    return False
                continue
            page = got[0]
            self._reset_pages([page])
            self._block_tables[i, slot.covered_pages()] = page
            slot.pages.append(page)
        if self._flight is not None and slot.covered_pages() > n0_pages:
            # growth (and any shed it forced) ran between this slot's
            # dispatches: the timeline shows it where the gap opened
            self._flight.record(i, EV_PAGE_GROW, pages=slot.covered_pages() - n0_pages,
                                dur_s=time.perf_counter() - t0_grow)
        return True

    def _pick_page_victim(self, d: int = 0):
        """LIFO shed order on page exhaustion of data rank ``d``'s pools,
        among what holds pages there: the staged prefill job first (it has
        produced nothing yet), then the newest staged remote job
        (``("remote", job_id)``: no client has a token yet either), then the
        most recently admitted active slot, which may be the growing slot
        itself. None when there is at most one tenant."""
        if self._prefill is not None and self._data_rank(self._prefill.slot) == d:
            return "job"
        if self._remote_jobs:
            # insertion order: the last key is the newest
            return ("remote", next(reversed(self._remote_jobs)))
        active = [j for j, s in enumerate(self._slots)
                  if s.active and s.pages and self._data_rank(j) == d]
        if len(active) < 2:
            return None
        return max(active, key=lambda j: self._slots[j].admit_seq)

    def _shed_error(self, why: str) -> ShedError:
        return ShedError(f"kv page pool exhausted: {why}",
                         retry_after_s=self.retry_after_hint())

    def _unpin_request(self, req: PendingRequest) -> None:
        """Drop a queued or staged request's adapter pin: the request owns
        it from submit until ``_commit_slot`` moves it to the slot, so every
        terminal path before commit (a queued or staged shed, the crash
        drain) comes here; the id goes to 0, so a path that fires twice
        cannot unpin twice."""
        if self._adapters is not None and req.adapter_id:
            self._adapters.unpin(req.adapter_id)
            req.adapter_id = 0

    def _shed_queued_request(self, req: PendingRequest, why: str):
        """Shed a request still in the scheduler: removed there (which books
        the shed against its tenant), its adapter pin dropped, then 503."""
        self._pending.remove(req)
        self._unpin_request(req)
        self._allocator.count_shed()
        logger.warning("shedding admission: %s", why)
        _emit(req.on_token, None)
        _resolve(req.fut, exc=self._shed_error(why))

    def _shed_slot(self, i: int, why: str):
        """Shed an ACTIVE slot mid-decode: its tokens are discarded and the
        client gets 503 + Retry-After."""
        slot = self._slots[i]
        self._allocator.count_shed()
        self._pending.count_shed(slot.tenant, slot.slo_class)
        logger.warning("shedding slot %d after %d generated tokens: %s", i, slot.n_new, why)
        fut, on_token = slot.future, slot.on_token
        if self._flight is not None:
            self._flight.record(i, EV_SHED, why=why)
            self._flight.complete(i, "shed", slot.n_new, self._tracer)
        # release BEFORE notifying: the shed client must never observe its
        # own pages as held
        self._release_slot(i)
        _emit(on_token, None)
        if fut is not None:
            _resolve(fut, exc=self._shed_error(why))

    def _shed_prefill_job(self, why: str):
        job = self._prefill
        self._prefill = None
        self._allocator.count_shed()
        self._pending.count_shed(job.req.tenant, job.req.slo_class)
        # before commit the request still owns its adapter pin: this shed is
        # its end, so the pin ends here
        self._unpin_request(job.req)
        logger.warning("shedding staged prefill (slot %d): %s", job.slot, why)
        if self._flight is not None:
            self._flight.record(job.slot, EV_SHED, why=why)
            self._flight.complete(job.slot, "shed", 0, self._tracer)
        on_token = self._slots[job.slot].on_token
        self._release_slot(job.slot)
        _emit(on_token, None)
        _resolve(job.req.fut, exc=self._shed_error(why))

    def _preempt_for_interactive(self) -> bool:
        """An interactive admission blocked by a staged batch-class prefill
        job (the one staged at a time, or one holding the last free slot)
        puts that job back into the scheduler: its pages (owned, shared trie
        pins, a CoW copy) are released as a shed's are, and the request
        keeps its sequence number, so it re-enters its tenant's queue where
        it left, with the ``preempted`` flag that makes it immune to a second
        preemption (so an interactive flood cannot livelock batch traffic).
        It keeps its adapter pin (the slot never took it). Active slots are
        never preempted. Without a local job, the newest staged batch-class
        REMOTE job goes back the same way (its queue record cancelled:
        exactly once against its worker). True when a job was put back."""
        job = self._prefill
        if job is not None and job.req.slo_class == BATCH and not job.req.preempted:
            self._prefill = None
            logger.info("preempting the staged prefill (slot %d, tenant %r) for an interactive "
                        "admission", job.slot, job.req.tenant)
            self._complete_preempted(job.slot, "local prefill")
            self._release_slot(job.slot)
            self._pending.push(job.req, requeue=True)
            return True
        for job_id in reversed(list(self._remote_jobs)):
            rjob = self._remote_jobs[job_id]
            if rjob.req.slo_class != BATCH or rjob.req.preempted:
                continue
            del self._remote_jobs[job_id]
            self._transfer.cancel(job_id)
            logger.info("preempting the staged remote prefill (slot %d, tenant %r) for an "
                        "interactive admission", rjob.slot, rjob.req.tenant)
            self._complete_preempted(rjob.slot, "staged remote prefill")
            self._release_slot(rjob.slot)
            self._pending.push(rjob.req, requeue=True)
            return True
        return False

    def _complete_preempted(self, i: int, what: str) -> None:
        """A preempted job's timeline ends here; its request re-enters the
        queue and records a new one when it is admitted again."""
        if self._flight is not None:
            self._flight.record(i, EV_SHED, why="preempted: " + what)
            self._flight.complete(i, "preempted", 0, self._tracer)

    def _release_slot(self, i: int):
        """Common slot teardown: page references dropped (owned pages back
        to the pool, shared trie pins decremented: the trie keeps its own
        reference), the adapter pin dropped and the slot's device id back to
        0, the device block-table row back to trash (stream-ordered:
        in-flight steps finish their reads first; reused pages are reset
        strictly after)."""
        slot = self._slots[i]
        slot.active = False
        slot.prefilling = False
        slot.future = None
        slot.on_token = None
        slot.ids = None
        slot.tenant = ""
        slot.slo_class = INTERACTIVE
        if slot.adapter_id:
            # the slot's pin held the adapter in the pool; the device id goes
            # back to the identity in stream order, so the freed slot's
            # ride-along compute gathers row 0, never a row a later load
            # rewrites
            self._adapters.unpin(slot.adapter_id)
            self._adapter_ids[i].fill_(0)
            slot.adapter_id = 0
        if not self.paged:
            return   # a dense slot owns no pages; its next admission resets its row
        if slot.pages:
            self._allocator.free(slot.pages)
            slot.pages = []
        if slot.shared:
            self._allocator.free(slot.shared)
            slot.shared = []
        self._block_tables[i].fill_(TRASH_PAGE)

    def _finish(self, i: int):
        """Complete slot ``i``: insert its history into the trie, release,
        THEN notify the client, so completion is observable only after the
        pool is consistent."""
        slot = self._slots[i]
        toks = slot.tokens
        if self.eos_id in toks:
            toks = toks[: toks.index(self.eos_id)]
        fut, on_token = slot.future, slot.on_token
        if self._flight is not None:
            # the tokens CREDITED (n_new), which the step events sum to; an
            # EOS trim shortens the client's list, never this count
            self._flight.complete(i, "done", slot.n_new, self._tracer)
        if self._radix is not None and slot.ids is not None and slot.adapter_id == 0:
            # base-adapter slots only (an adapted slot's KV carries its
            # deltas from the second layer on). The prompt and every
            # credited token but the last, in place:
            # each of those was fed to a step that has run (its KV is
            # written); the last one's write depends on the run-ahead
            hist = slot.ids + slot.tokens[:max(slot.n_new - 1, 0)]
            consumed = self._trie(self._data_rank(i)).insert(hist, slot.shared + slot.pages,
                                                             len(slot.shared))
            if consumed:
                # adopted or deduplicated pages are no longer the slot's
                slot.pages = [p for p in slot.pages if p not in consumed]
        self._release_slot(i)
        _emit(on_token, None)  # the stream's end, before the future resolves
        if fut is not None:
            _resolve(fut, toks)

    # ------------------------------------------------------------------
    # Pipelined decode: dispatch (producer) / drain (consumer)
    # ------------------------------------------------------------------
    def _dispatch_eligible(self) -> List[int]:
        """Slots worth stepping: active and not yet dispatched through their
        token budget or cache length."""
        return [i for i, s in enumerate(self._slots)
                if s.active and s.disp_new < s.max_new and s.dispatched_pos() < self.max_len]

    def _pick_k(self) -> int:
        """Fused-step block size for the next dispatch. K > 1 only when no
        request waits and no prefill is mid-flight (a fused block delays
        admission by K steps) and every eligible slot has room for K steps
        (so the block never overruns max_new or writes past the cache).
        Falling back to 1 instead of an arbitrary clamp keeps the programs
        at two (K = 1 and K = fuse_steps)."""
        if (self.fuse_steps <= 1 or self._prefill is not None
                or self._pending.next_request() is not None):
            return 1
        eligible = self._dispatch_eligible()
        if not eligible:
            return 1
        room = min(min(s.max_new - s.disp_new, self.max_len - s.dispatched_pos())
                   for s in (self._slots[i] for i in eligible))
        return self.fuse_steps if room >= self.fuse_steps else 1

    def _dispatch(self):
        """Enqueue one dispatch of k decode steps WITHOUT waiting for its
        tokens: a graph replay on a card, the eager program otherwise. In
        spec mode, one spec step (``_dispatch_spec``)."""
        if self._spec is not None:
            return self._dispatch_spec()
        k = self._pick_k()
        if self.paged:
            # grow every eligible slot's pages to cover this dispatch's k
            # writes, positions dispatched_pos() .. dispatched_pos() + k - 1;
            # a shed inside the loop can deactivate a later slot of the
            # snapshot
            for i in self._dispatch_eligible():
                if self._slots[i].active:
                    self._ensure_slot_pages(i, self._slots[i].dispatched_pos() + k - 1)
            if not self._dispatch_eligible():
                return
        t0 = time.perf_counter()
        lora = self._adapters is not None
        if self._graphs:
            toks = self._graphs[k].replay()
            self.server._decode_replays += 1
        elif self.paged:
            toks = self.server._get_decode_step_paged(self.S, self.n_pages, k, lora)(
                self._caches, self._last_tok, self._next_pos, self._keys, self._temp,
                self._block_tables, **self._lora(self._adapter_ids))
            self.server._decode_eager += 1
        else:
            toks = self.server._get_decode_step(self.S, self.max_len, k, lora)(
                self._caches, self._last_tok, self._next_pos, self._keys, self._temp,
                **self._lora(self._adapter_ids))
            self.server._decode_eager += 1
        self.server._decode_dispatch_times.append(time.perf_counter() - t0)
        host, event = self._stage_to_host(toks)
        snapshot = [(i, s.gen) for i, s in enumerate(self._slots) if s.active]
        for i, _ in snapshot:
            self._slots[i].disp_new += k
        self._inflight.append(_InFlight(host, event, k, snapshot, t0))
        self._inflight_hwm = max(self._inflight_hwm, len(self._inflight))

    def _dispatch_spec(self):
        """Enqueue one fused draft + verify step WITHOUT waiting for its
        tokens. Each slot advances a data-dependent 1..cap+1 tokens known
        only at drain, so the dispatch books the PESSIMISTIC cap + 1 into
        ``disp_new`` (page growth and the budget / cache-edge caps must
        cover the all-accepted case) and the drain reconciles it. The cap
        clamps the drafts offered: the controller's depth, the remaining
        budget (a step emits <= cap + 1) and the cache edge (writes reach
        next_pos + cap). The caps reach the device through the fixed
        ``_draft_cap`` buffer, in stream order."""
        K = self.spec_k
        caps = np.zeros((self.S,), np.int32)
        for i in self._dispatch_eligible():
            s = self._slots[i]
            cap = min(self._spec.cap(i), K, s.max_new - s.disp_new - 1,
                      (self.max_len - 1) - s.dispatched_pos())
            caps[i] = max(int(cap), 0)
        if self.paged:
            # pages to the step's furthest possible write; a shed inside the
            # loop can deactivate a later slot of the snapshot
            for i in self._dispatch_eligible():
                if self._slots[i].active:
                    self._ensure_slot_pages(i, self._slots[i].dispatched_pos() + int(caps[i]))
            if not self._dispatch_eligible():
                return
        self._draft_cap.copy_(self._to_device(caps))
        t0 = time.perf_counter()
        if self._spec_graph is not None:
            out = self._spec_graph.replay()
            self.server._decode_replays += 1
        else:
            out = self.server._get_spec_step(
                self.S, K, self.hist_len, mode=self.spec_mode, layout=self.layout,
                n_pages=self.n_pages, lora=self._adapters is not None)(
                    self._caches, self._last_tok, self._next_pos, self._keys, self._temp,
                    self._block_tables, self._hist, self._draft_cap, self._draft_caches,
                    **self._lora(self._adapter_ids))
            self.server._decode_eager += 1
        self.server._decode_dispatch_times.append(time.perf_counter() - t0)
        host, event = self._stage_to_host(out)   # tokens and advance: one copy
        snapshot = [(i, s.gen) for i, s in enumerate(self._slots) if s.active]
        booked = {}
        for i, _ in snapshot:
            booked[i] = int(caps[i]) + 1
            self._slots[i].disp_new += booked[i]
        self._inflight.append(_InFlight(host, event, 1, snapshot, t0, booked))
        self._inflight_hwm = max(self._inflight_hwm, len(self._inflight))

    def _reconcile_spec(self, rec: _InFlight, i: int, arr: np.ndarray) -> int:
        """Drain side of one spec step for live slot ``i``: reconcile its
        pessimistic booking to the device's actual advance, feed the
        controller, and return the advance, the count of tokens the drain
        credits (an EOS inside the accepted block still cuts it there)."""
        slot = self._slots[i]
        adv = int(arr[i, self.spec_k + 1])
        booked = rec.booked.get(i, 1)
        # restore: dispatched_pos() == the device's next_pos + what later
        # in-flight steps booked
        slot.disp_new -= booked - adv
        self._spec.observe(i, max(adv - 1, 0), booked - 1, adv)
        self.server._spec_accepted.append(adv)
        return adv

    def spec_stats(self) -> dict:
        """Speculation counters for ``llm_stats`` / the metrics: aggregate
        acceptance rate, accepted tokens per verify forward, the per-slot
        acceptance EMAs the controller steers by, and the draft-overhead
        fraction. Zeros when speculation is off."""
        if self._spec is None:
            return dict(SPEC_STATS_OFF)
        snap = self._spec.snapshot()
        return {"spec_mode": self.spec_mode, "spec_k": self.spec_k,
                "spec_accept_rate": snap["spec_accept_rate"],
                "spec_tokens_per_forward": snap["spec_tokens_per_forward"],
                "spec_slot_steps_total": snap["spec_slot_steps_total"],
                "spec_accept_rate_per_slot": self._spec.rates(),
                "spec_draft_overhead_fraction": snap["spec_draft_overhead_fraction"]}

    def _drain_one(self):
        """Consume the OLDEST in-flight dispatch: wait for its tokens only,
        then run all host bookkeeping (EOS, budgets, callbacks, slot
        release) while later dispatches keep the device busy."""
        rec: _InFlight = self._inflight.popleft()
        # host lag in decode STEPS, not dispatch records: a fused record
        # covers k steps, so depth 2 at K = 8 is a 16-step lag
        lag = rec.k + sum(r.k for r in self._inflight)
        t0 = time.perf_counter()
        if rec.event is not None:
            rec.event.synchronize()
        arr = rec.tokens.numpy()   # [S, k]
        now = time.perf_counter()
        self.server._decode_sync_times.append(now - t0)
        self.server._decode_host_lag.append(lag)
        self.server._last_decode_kv_bytes = self._cache_nbytes
        # drain to drain, floored at this record's dispatch so an idle gap
        # does not count; a fused record's wall is shared by its k steps
        base = rec.t_dispatch if self._last_drain_t is None else max(
            self._last_drain_t, rec.t_dispatch)
        per_step = max(now - base, 0.0) / rec.k
        self.server._decode_step_times.extend([per_step] * rec.k)
        self._last_drain_t = now
        for i, gen in rec.snapshot:
            slot = self._slots[i]
            if not slot.active or slot.gen != gen:
                continue  # trailing run-ahead tokens of a gone occupant
            # a plain record carries k tokens a slot, a spec record 1..cap+1
            n = rec.k if rec.booked is None else self._reconcile_spec(rec, i, arr)
            if slot.n_new >= slot.max_new:
                continue  # budget-exhausted slot riding along
            credited, finish = 0, False
            for j in range(n):
                tok = int(arr[i, j])
                slot.tokens.append(tok)
                slot.n_new += 1
                credited += 1
                # the gap before this token, at its drain: a fused or
                # accepted block surfaces in one burst, so its trailing
                # tokens read ~0
                self.server._inter_token_times.append(now - slot.t_last)
                slot.t_last = now
                if tok != self.eos_id:
                    _emit(slot.on_token, tok)
                if (tok == self.eos_id or slot.n_new >= slot.max_new
                        or slot.host_pos() >= self.max_len):
                    finish = True   # the rest of the block is dropped
                    break
            if credited:
                self._pending.count_tokens(slot.tenant, slot.slo_class, credited)
                if self._flight is not None:
                    # one event a slot a drain, before a finish completes
                    # the timeline: the tokens credited, the dispatch time
                    # (and a verify's offered and accepted drafts)
                    if rec.booked is None:
                        self._flight.record(i, EV_STEP, tokens=credited,
                                            t_dispatch=rec.t_dispatch)
                    else:
                        self._flight.record(i, EV_STEP, tokens=credited,
                                            offered=rec.booked.get(i, 1) - 1, accepted=n,
                                            t_dispatch=rec.t_dispatch)
            if finish:
                self._finish(i)

    # ------------------------------------------------------------------
    def _admit_pending(self) -> None:
        """Admission while a slot is free, in the scheduler's order (peek,
        try, then commit: a failed admission keeps the request queued). One
        local prefill job stages at a time; remote jobs, while slots are
        free. An interactive head that finds a staged batch-class job, or
        no free slot while such a job holds one, preempts that job
        (``_preempt_for_interactive``) and tries again."""
        while True:
            req = self._pending.next_request()
            if req is None:
                return
            if self._remote is not None:
                admitted = self._admit_remote(req)
            elif self.paged:
                admitted = self._prefill is None and self._admit_begin(req)
            else:
                admitted = self._admit(req)
            if not admitted:
                if req.slo_class == INTERACTIVE and self._preempt_for_interactive():
                    continue
                return
            # a shed inside _admit_begin already removed req (commit is then
            # a no-op)
            self._pending.commit(req)

    def _run(self):
        self.crashed = None  # a restarted loop is a recovered one
        # a new thread's current device is the default one: make the
        # batcher's current before any work (graph replays, the eager page
        # resets, imports and copies)
        on_device = (torch.cuda.device(self.device) if self.device.type == "cuda"
                     else contextlib.nullcontext())
        with torch.no_grad(), on_device:
            try:
                if self._broken is not None:
                    raise RuntimeError(f"the batcher's device failed ({self._broken!r}): its "
                                       f"pages and graphs cannot be trusted")
                self._loop()
            except Exception as e:  # the loop's boundary: fail every request
                # up first, so a fleet's health check ejects this replica
                # before a failed request routes back through dispatch
                self.crashed = e
                logger.exception("batcher loop died: %s", e)
                self._fail_all(e)
                # under the thread lock, so a submit racing this end was
                # either drained here and failed, or starts a new loop after
                with self._thread_lock:
                    if self._thread is threading.current_thread():
                        self._thread = None
                    stranded = self._pending.drain_all()
                self._fail_requests(stranded, e)

    def _loop(self):
        while True:
            self.heartbeat = self.clock()
            if self._chaos is not None:
                self._chaos(self)
            self._admit_pending()
            # disaggregated: every finished handoff joins before the next
            # dispatch
            if self._transfer is not None and self._transfer.ready_depth():
                self._consume_handoffs()
            # producer: keep pipeline_depth steps ahead of the host
            while len(self._inflight) < self.pipeline_depth and self._dispatch_eligible():
                self._dispatch()
            # chunked prefill interleaves: ONE chunk per loop turn
            if self._prefill is not None:
                self._prefill_step()
                if self._inflight:
                    self._drain_one()
                continue
            # consumer: drain the oldest step one (or more) behind
            if self._inflight:
                self._drain_one()
                continue
            if self._dispatch_eligible():
                continue
            if self._closed:
                self._fail_all(ShedError("batcher closed; retry"))
                return
            # cleared before the checks, so a submit or a handoff that lands
            # after them still ends the wait
            self._wakeup.clear()
            if self._transfer is not None and self._transfer.ready_depth():
                continue
            if self._pending.next_request() is not None and not self._remote_jobs:
                continue
            self._wakeup.wait(timeout=0.5)

    def _quiesce(self) -> None:
        """Wait for every dispatch, chunk and copy this batcher enqueued (a
        no-op on the CPU): its slots' pages are read and written on the
        stream until then."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _fail_all(self, exc: BaseException):
        """Shutdown/crash path: no request may leave its future hanging, and
        no page, pin or adapter may stay held. The stream is waited on
        first (the dispatches in flight still write the slots' pages), then
        each slot is released as a finished one is, before its client is
        told. When the wait fails the device is broken (``_broken``): the
        requests fail, and the slots are cleared on the host only."""
        self._inflight.clear()
        try:
            self._quiesce()
        except Exception as e:
            logger.exception("the batcher's stream failed; its pages are not released: %s", e)
            self._broken = e
        if self._flight is not None:
            # every open timeline ends once, here, whatever the wait gave
            for i in self._flight.live_slots():
                self._flight.complete(i, "error", self._slots[i].n_new if self._slots[i].active
                                      else 0, self._tracer)
        if self._broken is None and self._remote_jobs:
            self._fail_remote_jobs(exc)
        job, self._prefill = self._prefill, None
        if job is not None and self._broken is None:
            # before commit the request owns its adapter pin
            self._unpin_request(job.req)
        for i, slot in enumerate(self._slots):
            if slot.active or slot.prefilling:
                fut, on_token = slot.future, slot.on_token
                if self._broken is None:
                    self._release_slot(i)
                else:
                    slot.active = slot.prefilling = False
                    slot.future = slot.on_token = None
                _emit(on_token, None)
                if fut is not None:
                    _resolve(fut, exc=exc)
        # a staged remote job's slot is one of those (broken: its record goes)
        self._remote_jobs.clear()
        self._fail_requests(self._pending.drain_all(), exc)

    def _fail_requests(self, reqs, exc: BaseException) -> None:
        """Fail queued requests, each adapter pin dropped."""
        for req in reqs:
            try:
                self._unpin_request(req)
            except ValueError:
                pass  # teardown must not mask the original error
            _emit(req.on_token, None)
            _resolve(req.fut, exc=exc)


class BatcherService:
    """Owns a ContinuousBatcher so every transport thread reaches ONE shared
    batch: ``submit`` returns a Future, ``submit_sync`` blocks on it."""

    def __init__(self, server: LLMServer, max_slots: int = 4, **batcher_kw: Any):
        """``batcher_kw``: further ``ContinuousBatcher`` arguments."""
        self.batcher = ContinuousBatcher(server, max_slots=max_slots,
                                         max_len=server.continuous_batching_max_len,
                                         device=server.device, **batcher_kw)
        # submissions whose futures have not settled: a replica fleet
        # detaches a drained replica only while this is 0
        self._unsettled = 0
        self._unsettled_lock = threading.Lock()

    def submit(self, prompt: Any, max_new_tokens: Optional[int] = None,
               seed: Optional[int] = None, info: Optional[dict] = None,
               on_token: Optional[Any] = None, **identity: Any) -> Future:
        """The Future of the final token list; ``on_token`` (optional)
        fires per token from the batcher's loop thread, so a transport
        thread pumps its response stream from it. Cancelling the Future (a
        disconnect) is safe. ``identity``: ``tenant``, ``slo_class``,
        ``adapter``, ``deadline_s``, ``resume_tokens``, ``trace``
        (``ContinuousBatcher.submit``)."""
        with self._unsettled_lock:
            self._unsettled += 1
        try:
            fut = self.batcher.submit(prompt, max_new_tokens, seed=seed, info=info,
                                      on_token=on_token, **identity)
        except BaseException:
            self._settled(None)
            raise
        fut.add_done_callback(self._settled)
        return fut

    def _settled(self, _fut) -> None:
        with self._unsettled_lock:
            self._unsettled -= 1

    def drain(self) -> None:
        """The fleet's scale-down mark on this replica's batcher."""
        self.batcher.drain()

    def resume(self) -> None:
        """A cancelled drain: the batcher rejoins fleet dispatch."""
        self.batcher.resume()

    def is_idle(self) -> bool:
        """No submission unsettled and no remote prefill staged: nothing
        queued, prefilling or decoding for a client (a replica fleet's
        detach gate; pages the prefix cache keeps are not work)."""
        with self._unsettled_lock:
            return self._unsettled == 0 and not self.batcher._remote_jobs

    def submit_sync(self, prompt: Any, max_new_tokens: Optional[int] = None,
                    timeout_s: float = 600.0, seed: Optional[int] = None,
                    info: Optional[dict] = None, **identity: Any) -> List[int]:
        return self.submit(prompt, max_new_tokens, seed=seed, info=info,
                           **identity).result(timeout_s)

    def close(self) -> None:
        self.batcher.close()


_service_init_lock = threading.Lock()


def get_batcher_service(component: Any) -> Optional[BatcherService]:
    """The component's shared BatcherService, created on first use when the
    component opted in (``continuous_batching`` slots > 0); None otherwise.
    Creation is locked: two first requests racing would each allocate a
    page pool and step the device. A replica fleet (``is_fleet``,
    ``runtime/engine.ReplicaSet``) is its own service: it spreads submits
    over its replicas' batchers and is never wrapped in one."""
    if getattr(component, "is_fleet", False):
        return component
    svc = getattr(component, "_batcher_service", None)
    if svc is not None:
        return svc
    slots = int(getattr(component, "continuous_batching", 0) or 0)
    if slots <= 0 or not hasattr(component, "generate"):
        return None
    with _service_init_lock:
        svc = getattr(component, "_batcher_service", None)
        if svc is None:
            svc = BatcherService(component, max_slots=slots)
            component._batcher_service = svc
    return svc


def ensure_stream_service(component: Any) -> BatcherService:
    """Streaming without continuous batching: one shared 1-slot service per
    component, built under the same lock (never one per request). On a card
    building it captures its own prefill and decode graphs. A component
    with ``continuous_batching`` streams through its shared batch, a
    replica fleet through itself (``get_batcher_service``)."""
    svc = get_batcher_service(component)
    if svc is not None:
        return svc
    with _service_init_lock:
        svc = getattr(component, "_batcher_service", None)
        if svc is None:
            t0 = time.perf_counter()
            svc = BatcherService(component, max_slots=1)
            component._batcher_service = svc
            logger.info("1-slot stream service built in %.3f s", time.perf_counter() - t0)
    return svc


__all__ = ["BatcherService", "ContinuousBatcher", "PageAllocator",
           "DEFAULT_PAGE_SIZE", "DEFAULT_PREFILL_CHUNK", "ensure_stream_service",
           "get_batcher_service", "pow2_bucket"]
