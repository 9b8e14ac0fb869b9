"""Continuous batching for LLM decode over the paged KV pool, ported to
PyTorch.

Port of ``seldon_core_tpu/runtime/batcher.py`` (paged layout). Requests join
and leave a fixed pool of S decode slots between decode steps, so one decode
program serves overlapping requests at arbitrary arrival times:

- KV lives in a GLOBAL pool of fixed-size pages (``init_paged_kv_caches``)
  addressed through a per-slot block table on the device; pages are handed
  out by ``PageAllocator`` (host-side, lock-guarded) as sequences grow;
- admission is FIFO; its prefill runs in chunks of ``prefill_chunk`` tokens
  interleaved with decode steps, written straight into the pool through the
  slot's block-table row;
- on page exhaustion the newest tenant is shed (503 + Retry-After) — the
  decode loop never raises; a sole tenant that outgrows the pool stops with
  the tokens it has.

Pipelined decode. Per-slot token, position and sampling-key state stay on
the device and are threaded from one step into the next, so dispatching
step t+1 never waits for step t's tokens. On a card this falls out of
asynchronous launches: each dispatch enqueues the step's kernels, then a
non-blocking copy of its tokens into pinned host memory and an event; the
host reads step t's tokens (waiting on that event only) after step t+1 is
already enqueued, so the device never idles on host bookkeeping. Up to
``decode_pipeline_depth`` steps are in flight. A slot that finishes, or is
freed and re-admitted, between a step's dispatch and its drain is detected
by a per-slot generation counter and its trailing tokens are dropped, never
surfaced. Their KV writes land in pages that are reset or rewritten strictly
after them in stream order.

Every pool, block-table and slot-state update is an in-place tensor update
enqueued on the same stream as the decode steps (the JAX package donated
these buffers to jitted ops and relied on device program order in the same
way).

The loop runs on a dedicated thread; ``submit`` returns a
``concurrent.futures.Future``. There is no asyncio dependency.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.models.transformer import (
    NULL_PAGE,
    PAD_POS,
    RESERVED_PAGES,
    TRASH_PAGE,
    init_paged_kv_caches,
    normalize_kv_cache_layout,
)
from seldon_core_tpu_torch.runtime.resilience import DEFAULT_RETRY_AFTER_S, ShedError
from seldon_core_tpu_torch.servers.llmserver import (LLMServer, bucket,
                                                     sample_tokens, seed_key,
                                                     split_keys)

logger = logging.getLogger(__name__)

DEFAULT_PAGE_SIZE = 64
DEFAULT_PREFILL_CHUNK = 256


class PageAllocator:
    """Host-side refcounted free-list allocator over the global KV page
    pool (copied from the JAX package).

    Pages 0/1 are reserved (NULL/TRASH); the rest are handed out
    lowest-id-first, all-or-nothing, at refcount 1. ``free`` is one uniform
    decrement-and-free-on-zero. Every state transition happens under
    ``self._lock``. Over-freeing raises — a page freed past zero would be
    handed to two slots and silently cross-corrupt their KV."""

    def __init__(self, total_pages: int, page_size: int):
        if total_pages <= RESERVED_PAGES:
            raise ValueError(
                f"page pool needs > {RESERVED_PAGES} pages (got {total_pages})")
        self.total = int(total_pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        # pop() from the tail hands out the lowest free id: deterministic
        # placement makes parity tests reproducible
        self._free = list(range(self.total - 1, RESERVED_PAGES - 1, -1))
        self._refs: Dict[int, int] = {}   # page -> refcount (allocated only)
        self.shed_total = 0

    @property
    def capacity(self) -> int:
        return self.total - RESERVED_PAGES

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages at refcount 1, all-or-nothing; None when the pool
        can't cover it."""
        with self._lock:
            if n > len(self._free):
                return None
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._refs[p] = 1
            return pages

    def retain(self, pages: Sequence[int]) -> None:
        """Add one reference to each (already-allocated) page."""
        with self._lock:
            for p in pages:
                if p not in self._refs:
                    raise ValueError(f"retain of unallocated page {p}")
            for p in pages:
                self._refs[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page rejoins the free list when
        its count reaches zero. Raises on a page not currently allocated."""
        with self._lock:
            for p in pages:
                rc = self._refs.get(p)
                if rc is None or not (RESERVED_PAGES <= p < self.total):
                    raise ValueError(f"double/invalid free of page {p}")
                if rc > 1:
                    self._refs[p] = rc - 1
                else:
                    del self._refs[p]
                    self._free.append(p)

    def refs_of(self, page: int) -> int:
        with self._lock:
            return self._refs.get(page, 0)

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def count_shed(self) -> None:
        with self._lock:
            self.shed_total += 1

    def stats(self):
        """(total, in_use, shed_total) — one consistent snapshot."""
        with self._lock:
            return self.total, self.capacity - len(self._free), self.shed_total


class _Request:
    """One queued request (FIFO admission)."""

    __slots__ = ("ids", "max_new", "fut", "info", "seed", "t_arrival")

    def __init__(self, ids, max_new, fut, info, seed, t_arrival):
        self.ids = ids
        self.max_new = max_new
        self.fut = fut
        self.info = info
        self.seed = seed
        self.t_arrival = t_arrival


class _PrefillJob:
    """One chunked admission in progress: the slot it targets, the (already
    truncated) prompt, the next write offset, and the device block-table row
    its chunks write through. One job runs at a time; decode dispatches
    interleave between its chunks."""

    __slots__ = ("slot", "ids", "L", "next", "chunk", "max_new", "fut",
                 "info", "seed", "bt_row", "t_arrival")

    def __init__(self, slot, ids, start, chunk, max_new, fut, info, seed, bt_row,
                 t_arrival=None):
        self.slot = slot
        self.ids = ids
        self.L = len(ids)
        self.next = start            # first position the next chunk writes
        self.chunk = chunk
        self.max_new = max_new
        self.fut = fut
        self.info = info
        self.seed = seed
        self.bt_row = bt_row         # device [1, n_pages] int32
        self.t_arrival = t_arrival


class _Slot:
    __slots__ = ("future", "tokens", "true_len", "n_new", "max_new", "active",
                 "gen", "disp_new", "pages", "prefilling", "admit_seq")

    def __init__(self):
        self.active = False
        self.future: Optional[Future] = None
        self.tokens: List[int] = []
        self.true_len = 0
        self.n_new = 0          # tokens the HOST has processed (drain side)
        self.max_new = 0
        # pipelining state: gen disambiguates a slot reused between a step's
        # dispatch and its drain; disp_new is the DISPATCH-side token count
        self.gen = 0
        self.disp_new = 0
        # owned page ids (host mirror of the slot's block-table row), whether
        # a chunked prefill is mid-flight for it, and its admission sequence
        # number (newest admitted sheds first on page exhaustion)
        self.pages: List[int] = []
        self.prefilling = False
        self.admit_seq = 0

    # the n-th generated token sits at position true_len + n - 1
    def host_pos(self) -> int:
        return self.true_len + self.n_new - 1

    def dispatched_pos(self) -> int:
        return self.true_len + self.disp_new - 1


class _InFlight:
    """One dispatched decode step the host has not yet drained: its tokens
    (a pinned host buffer being filled by an async copy on a card), the
    event that marks the copy done, the per-slot (index, gen) snapshot taken
    at dispatch, and the dispatch timestamp."""

    __slots__ = ("tokens", "event", "snapshot", "t_dispatch")

    def __init__(self, tokens, event, snapshot, t_dispatch):
        self.tokens = tokens
        self.event = event
        self.snapshot = snapshot
        self.t_dispatch = t_dispatch


class ContinuousBatcher:
    def __init__(
        self,
        server: LLMServer,
        max_slots: int = 4,
        max_len: Optional[int] = None,
        len_buckets: Optional[Sequence[int]] = None,
        pipeline_depth: Optional[int] = None,
        layout: Optional[str] = None,
        page_size: Optional[int] = None,
        pool_pages: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        device: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        server.load()
        if server.device != self.device:
            raise ValueError(f"batcher device {self.device} != server device {server.device}")
        if layout is None:
            layout = getattr(server, "kv_cache_layout", "paged")
        if normalize_kv_cache_layout(layout) != "paged":
            raise NotImplementedError(
                "the dense batcher layout (kv_cache_layout='dense') arrives with "
                "a later slice; this port's batcher is paged")
        self.server = server
        self.S = int(max_slots)
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
        ps = int(page_size if page_size is not None else server.kv_page_size or 0) \
            or DEFAULT_PAGE_SIZE
        if ps <= 0:
            raise ValueError(f"kv_page_size={ps} must be positive")
        self.page_size = ps
        self.n_pages = -(-self.max_len // ps)   # pages per slot
        pool = int(pool_pages if pool_pages is not None else server.kv_pool_pages or 0)
        # 0 = fully provisioned (never sheds on pages); smaller pools oversubscribe
        self.pool_pages = pool or (self.S * self.n_pages + RESERVED_PAGES)
        if self.pool_pages - RESERVED_PAGES < self.n_pages:
            raise ValueError(
                f"kv_pool_pages={self.pool_pages} cannot hold even one "
                f"max_len sequence ({self.n_pages} pages of {ps} tokens "
                f"+ {RESERVED_PAGES} reserved)")
        chunk = int(prefill_chunk if prefill_chunk is not None else server.prefill_chunk or 0)
        self.prefill_chunk = chunk or DEFAULT_PREFILL_CHUNK
        self._allocator = PageAllocator(self.pool_pages, ps)

        self._slots = [_Slot() for _ in range(self.S)]
        self._pending: deque = deque()
        self._pending_lock = threading.Lock()
        self._prefill: Optional[_PrefillJob] = None
        self._admit_seq = 0
        self._inflight: deque = deque()
        self._inflight_hwm = 0
        self._last_drain_t: Optional[float] = None
        self._wakeup = threading.Event()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._thread_lock = threading.Lock()
        self.crashed: Optional[BaseException] = None

        dev = self.device
        self._caches = init_paged_kv_caches(cfg, self.pool_pages, ps, server.kv_cache_dtype,
                                            device=dev)
        # Block table, one row per slot, all-TRASH while a slot is free so
        # the ride-along decode writes of inactive slots land in the trash
        # page; rows switch to real pages at activation and back at release.
        self._block_tables = torch.full((self.S, self.n_pages), TRASH_PAGE,
                                        dtype=torch.int32, device=dev)
        # device-resident per-slot decode state, threaded through every step
        self._last_tok = torch.zeros((self.S,), dtype=torch.int64, device=dev)
        self._next_pos = torch.zeros((self.S,), dtype=torch.int32, device=dev)
        self._keys = torch.zeros((self.S,), dtype=torch.int64, device=dev)
        self._rng = seed_key(server.seed)
        self._temp = float(server.temperature)

    # ------------------------------------------------------------------
    # Host <-> device staging
    # ------------------------------------------------------------------
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A small host array on the device without stalling the stream:
        a pinned copy moves asynchronously, in stream order."""
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
        doubled near page-pool exhaustion, clamped to [base, 30 s]."""
        base = float(DEFAULT_RETRY_AFTER_S)
        with self._pending_lock:
            queued = len(self._pending)
        queued += sum(1 for s in self._slots if s.active or s.prefilling)
        hint = base * max(-(-queued // max(self.S, 1)), 1)
        total, in_use, _ = self._allocator.stats()
        if in_use / max(total - RESERVED_PAGES, 1) >= 0.9:
            hint *= 2
        return float(min(max(hint, base), max(30.0, base)))

    def page_stats(self) -> dict:
        """Pool gauges: total and in-use pages, page size, sheds so far."""
        total, in_use, sheds = self._allocator.stats()
        return {"kv_pages_total": total, "kv_pages_in_use": in_use,
                "kv_page_size": self.page_size, "kv_page_sheds": sheds}

    # ------------------------------------------------------------------
    def submit(self, prompt: Any, max_new_tokens: Optional[int] = None,
               seed: Optional[int] = None, info: Optional[dict] = None) -> Future:
        """prompt: str or token sequence. Returns a Future of the generated
        token ids. ``seed`` pins the request's sampling chain to
        ``generate(..., seed=seed)``'s. ``info`` is filled at admission with
        a ``truncated_prompt`` record when the slot cache cuts the prompt."""
        if self._closed:
            raise ShedError("batcher closed; retry")
        if isinstance(prompt, str):
            ids = self.server._tokenizer.encode(prompt)
        else:
            ids = [int(t) for t in np.asarray(prompt).ravel()]
        if not ids:
            raise ValueError("empty prompt")
        fut: Future = Future()
        req = _Request(ids, int(max_new_tokens or self.server.max_new_tokens), fut,
                       info, seed, time.perf_counter())
        with self._pending_lock:
            self._pending.append(req)
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
        plen = min(bucket(n, self.len_buckets), self.server._cfg.max_seq_len,
                   self.max_len - 1)
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

    # ------------------------------------------------------------------
    def _truncate_prompt(self, ids: List[int], max_new: int, info: Optional[dict]):
        """Admission clipping: never beyond the model's context, and leave
        room for at least one generated token. Returns (ids, plen bucket)."""
        plen = min(bucket(len(ids), self.len_buckets), self.server._cfg.max_seq_len,
                   self.max_len - 1)
        if len(ids) > plen:
            if info is not None:
                info["truncated_prompt"] = {"prompt_tokens": len(ids),
                                            "kept_tokens": plen,
                                            "max_len": self.max_len}
            logger.warning("batcher truncating %d-token prompt to its last %d tokens "
                           "(slot cache max_len=%d)", len(ids), plen, self.max_len)
        return ids[-plen:], plen

    def _sample_first(self, first_logits: torch.Tensor, seed: Optional[int]):
        """First token from the prefill logits on generate()'s chain:
        ``seed_key(seed)`` for a seeded request, else a fresh key split off
        the batcher's own chain. Returns (token, next key) as host ints —
        one sync per admission, not per token."""
        if seed is not None:
            key = seed_key(seed)
        else:
            self._rng, key = split_keys(self._rng)
        keys = torch.tensor([key], dtype=torch.int64, device=self.device)
        keys, tok = sample_tokens(keys, first_logits[None].float(), self._temp,
                                  self.server.top_k)
        return int(tok[0]), int(keys[0])

    def _commit_slot(self, i: int, first: int, key: int, L: int, max_new: int,
                     fut: Future, t_arrival: Optional[float]):
        """Thread the new occupant's state into the device arrays and
        surface the first token. The writes are stream-ordered after every
        already-dispatched step, so in-flight steps still see (and waste
        compute on) the old state while the next one picks up the new."""
        slot = self._slots[i]
        slot.active = True
        slot.prefilling = False
        slot.future = fut
        slot.true_len = L
        slot.max_new = max_new
        slot.n_new = 1
        slot.tokens = [first]
        if t_arrival is not None:
            self.server._ttft_times.append(time.perf_counter() - t_arrival)
        slot.gen += 1          # invalidates in-flight tokens for the old occupant
        slot.disp_new = 1      # the prefill-sampled first token counts
        self._admit_seq += 1
        slot.admit_seq = self._admit_seq
        # in place, on the decode stream (the JAX package's donated set_slot)
        self._last_tok[i] = first
        self._next_pos[i] = L
        self._keys[i] = key
        if first == self.eos_id or max_new <= 1:
            self._finish(i)

    def _reset_pages(self, pages: List[int]) -> None:
        """Position rows of newly allocated pages back to PAD_POS: a page off
        the free list still holds its previous owner's positions, which
        another sequence's mask would otherwise attend. In place."""
        ids = self._to_device(np.asarray(pages, np.int64))
        for layer in self._caches:
            layer[-1].index_fill_(0, ids, PAD_POS)

    def _admit_begin(self, req: _Request) -> bool:
        """Paged admission, phase 1 (host side, cheap): allocate the
        prompt's pages, reset their positions, and stage a chunked-prefill
        job. True when the request was CONSUMED (staged, or shed with 503);
        False leaves it queued."""
        free = next((i for i, s in enumerate(self._slots)
                     if not s.active and not s.prefilling), None)
        if free is None:
            return False
        ids, plen = self._truncate_prompt(req.ids, req.max_new, req.info)
        L = len(ids)
        n0 = -(-L // self.page_size)
        fresh = self._allocator.alloc(n0)
        if fresh is None:
            # an admission always fits an empty pool (prompts cap at
            # max_len-1 and the pool holds >= one max_len sequence), so with
            # nothing in flight to free a page, shed now instead of waiting
            if not any(s.active or s.prefilling for s in self._slots):
                self._shed_queued_request(
                    req, f"admission needs {n0} KV pages (pool capacity "
                         f"{self._allocator.capacity}, {self._allocator.stats()[1]} in use)")
                return True
            return False
        slot = self._slots[free]
        slot.pages = list(fresh)
        slot.prefilling = True
        slot.future = req.fut
        self._reset_pages(fresh)
        row = np.full((1, self.n_pages), NULL_PAGE, np.int32)
        row[0, :n0] = fresh
        self._prefill = _PrefillJob(free, ids, 0, min(self.prefill_chunk, plen), req.max_new,
                                    req.fut, req.info, req.seed, self._to_device(row),
                                    t_arrival=req.t_arrival)
        return True

    def _prefill_step(self):
        """One chunked-prefill dispatch: write the next ``chunk`` prompt
        tokens into the pool through the job's block-table row. Only the
        LAST chunk syncs (its logits seed the first token)."""
        job = self._prefill
        C = job.chunk
        start = job.next
        part = job.ids[start:start + C]
        n = len(part)
        toks = np.zeros((1, C), np.int64)
        pos = np.full((1, C), PAD_POS, np.int32)
        toks[0, :n] = part
        pos[0, :n] = np.arange(start, start + n)
        logits = self.server._prefill_chunk(self._caches, job.bt_row,
                                            self._to_device(toks), self._to_device(pos))
        job.next = start + n
        if job.next >= job.L:
            self._activate(job, logits[0, n - 1])

    def _activate(self, job: _PrefillJob, first_logits: torch.Tensor):
        """Paged admission, final phase: sample the first token, point the
        slot's device block-table row at its pages, commit the slot."""
        first, key = self._sample_first(first_logits, job.seed)
        self._block_tables[job.slot].copy_(job.bt_row[0])
        self._prefill = None
        self._commit_slot(job.slot, first, key, job.L, job.max_new, job.fut,
                          job.t_arrival)

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
        while len(slot.pages) < need:
            got = self._allocator.alloc(1)
            if got is None:
                victim = self._pick_page_victim()
                if victim is None:
                    logger.warning("kv page pool exhausted with no shed candidate: "
                                   "slot %d ends at %d generated tokens", i, slot.n_new)
                    self._finish(i)
                    return False
                if victim == "job":
                    self._shed_prefill_job("page pool exhausted by decode")
                    continue
                self._shed_slot(victim, "page pool exhausted")
                if victim == i:
                    return False
                continue
            page = got[0]
            self._reset_pages([page])
            self._block_tables[i, len(slot.pages)] = page
            slot.pages.append(page)
        return True

    def _pick_page_victim(self):
        """LIFO shed order on page exhaustion: the staged prefill job first
        (it has produced nothing yet), then the most recently admitted
        active slot, which may be the growing slot itself. None when there
        is at most one tenant."""
        if self._prefill is not None:
            return "job"
        active = [j for j, s in enumerate(self._slots) if s.active and s.pages]
        if len(active) < 2:
            return None
        return max(active, key=lambda j: self._slots[j].admit_seq)

    def _shed_error(self, why: str) -> ShedError:
        return ShedError(f"kv page pool exhausted: {why}",
                         retry_after_s=self.retry_after_hint())

    def _shed_queued_request(self, req: _Request, why: str):
        with self._pending_lock:
            if self._pending and self._pending[0] is req:
                self._pending.popleft()
        self._allocator.count_shed()
        logger.warning("shedding admission: %s", why)
        req.fut.set_exception(self._shed_error(why))

    def _shed_slot(self, i: int, why: str):
        """Shed an ACTIVE slot mid-decode: its tokens are discarded and the
        client gets 503 + Retry-After."""
        slot = self._slots[i]
        self._allocator.count_shed()
        logger.warning("shedding slot %d after %d generated tokens: %s", i, slot.n_new, why)
        fut = slot.future
        # release BEFORE notifying: the shed client must never observe its
        # own pages as held
        self._release_slot(i)
        if fut is not None:
            fut.set_exception(self._shed_error(why))

    def _shed_prefill_job(self, why: str):
        job = self._prefill
        self._prefill = None
        self._allocator.count_shed()
        logger.warning("shedding staged prefill (slot %d): %s", job.slot, why)
        self._release_slot(job.slot)
        job.fut.set_exception(self._shed_error(why))

    def _release_slot(self, i: int):
        """Common slot teardown: owned pages back to the pool, the device
        block-table row back to trash (stream-ordered: in-flight steps
        finish their reads first; reused pages are reset strictly after)."""
        slot = self._slots[i]
        slot.active = False
        slot.prefilling = False
        slot.future = None
        if slot.pages:
            self._allocator.free(slot.pages)
            slot.pages = []
        self._block_tables[i].fill_(TRASH_PAGE)

    def _finish(self, i: int):
        """Complete slot ``i``: release, THEN notify the client, so
        completion is observable only after the pool is consistent."""
        slot = self._slots[i]
        toks = slot.tokens
        if self.eos_id in toks:
            toks = toks[: toks.index(self.eos_id)]
        fut = slot.future
        self._release_slot(i)
        if fut is not None:
            fut.set_result(toks)

    # ------------------------------------------------------------------
    # Pipelined decode: dispatch (producer) / drain (consumer)
    # ------------------------------------------------------------------
    def _dispatch_eligible(self) -> List[int]:
        """Slots worth stepping: active and not yet dispatched through their
        token budget or cache length."""
        return [i for i, s in enumerate(self._slots)
                if s.active and s.disp_new < s.max_new and s.dispatched_pos() < self.max_len]

    def _dispatch(self):
        """Enqueue one decode step WITHOUT waiting for its tokens."""
        # grow every eligible slot's pages to cover this dispatch's write;
        # a shed inside the loop can deactivate a later slot of the snapshot
        for i in self._dispatch_eligible():
            if self._slots[i].active:
                self._ensure_slot_pages(i, self._slots[i].dispatched_pos())
        if not self._dispatch_eligible():
            return
        t0 = time.perf_counter()
        self._last_tok, self._next_pos, self._keys, toks = self.server._decode_step_paged(
            self._caches, self._last_tok, self._next_pos, self._keys, self._temp,
            self._block_tables)
        host, event = self._stage_to_host(toks)
        snapshot = [(i, s.gen) for i, s in enumerate(self._slots) if s.active]
        for i, _ in snapshot:
            self._slots[i].disp_new += 1
        self._inflight.append(_InFlight(host, event, snapshot, t0))
        self._inflight_hwm = max(self._inflight_hwm, len(self._inflight))

    def _drain_one(self):
        """Consume the OLDEST in-flight step: wait for its tokens only, then
        run all host bookkeeping (EOS, budgets, callbacks, slot release)
        while later steps keep the device busy."""
        rec: _InFlight = self._inflight.popleft()
        if rec.event is not None:
            rec.event.synchronize()
        arr = rec.tokens.numpy()
        now = time.perf_counter()
        base = rec.t_dispatch if self._last_drain_t is None else max(
            self._last_drain_t, rec.t_dispatch)
        self.server._decode_step_times.append(max(now - base, 0.0))
        self._last_drain_t = now
        for i, gen in rec.snapshot:
            slot = self._slots[i]
            if not slot.active or slot.gen != gen:
                continue  # trailing run-ahead token of a gone occupant
            if slot.n_new >= slot.max_new:
                continue  # budget-exhausted slot riding along
            tok = int(arr[i])
            slot.tokens.append(tok)
            slot.n_new += 1
            if (tok == self.eos_id or slot.n_new >= slot.max_new
                    or slot.host_pos() >= self.max_len):
                self._finish(i)

    # ------------------------------------------------------------------
    def _next_request(self) -> Optional[_Request]:
        with self._pending_lock:
            return self._pending[0] if self._pending else None

    def _pop_request(self, req: _Request) -> None:
        with self._pending_lock:
            if self._pending and self._pending[0] is req:
                self._pending.popleft()

    def _run(self):
        try:
            with torch.no_grad():
                self._loop()
        except Exception as e:  # the loop's boundary: fail every request
            self.crashed = e
            logger.exception("batcher loop died: %s", e)
            self._fail_all(e)

    def _loop(self):
        while True:
            # FIFO admission while a slot is free (peek, admit, then pop:
            # a failed admit keeps the request at the head)
            while self._prefill is None:
                req = self._next_request()
                if req is None or not self._admit_begin(req):
                    break
                self._pop_request(req)
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
            if self._next_request() is not None:
                continue
            self._wakeup.wait(timeout=0.5)
            self._wakeup.clear()

    def _fail_all(self, exc: BaseException):
        """Shutdown/crash path: no request may leave its future hanging."""
        self._inflight.clear()
        self._prefill = None
        for slot in self._slots:
            if slot.active or slot.prefilling:
                if slot.future is not None and not slot.future.done():
                    slot.future.set_exception(exc)
                slot.active = slot.prefilling = False
                slot.future = None
        with self._pending_lock:
            pending = list(self._pending)
            self._pending.clear()
        for req in pending:
            if not req.fut.done():
                req.fut.set_exception(exc)


class BatcherService:
    """Owns a ContinuousBatcher so every transport thread reaches ONE shared
    batch: ``submit`` returns a Future, ``submit_sync`` blocks on it."""

    def __init__(self, server: LLMServer, max_slots: int = 4):
        self.batcher = ContinuousBatcher(server, max_slots=max_slots,
                                         max_len=server.continuous_batching_max_len,
                                         device=server.device)

    def submit(self, prompt: Any, max_new_tokens: Optional[int] = None,
               seed: Optional[int] = None, info: Optional[dict] = None) -> Future:
        return self.batcher.submit(prompt, max_new_tokens, seed=seed, info=info)

    def submit_sync(self, prompt: Any, max_new_tokens: Optional[int] = None,
                    timeout_s: float = 600.0, seed: Optional[int] = None,
                    info: Optional[dict] = None) -> List[int]:
        return self.submit(prompt, max_new_tokens, seed=seed, info=info).result(timeout_s)

    def close(self) -> None:
        self.batcher.close()


_service_init_lock = threading.Lock()


def get_batcher_service(component: Any) -> Optional[BatcherService]:
    """The component's shared BatcherService, created on first use when the
    component opted in (``continuous_batching`` slots > 0); None otherwise.
    Creation is locked: two first requests racing would each allocate a
    page pool and step the device."""
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


__all__ = ["BatcherService", "ContinuousBatcher", "PageAllocator",
           "DEFAULT_PAGE_SIZE", "DEFAULT_PREFILL_CHUNK", "get_batcher_service"]
