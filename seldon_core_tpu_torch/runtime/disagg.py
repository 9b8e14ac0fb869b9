"""Disaggregated prefill/decode serving, ported to PyTorch: the host half.

Port of ``seldon_core_tpu/runtime/disagg.py``. Admission prefill runs on
prefill workers and the decode batch on the batcher
(``runtime/batcher.py``, ``disaggregation="remote_prefill"``); the prefilled
KV crosses from a worker's staging page pool into the batcher's pool as a
handoff:

- ``TransferQueue``: the lock-guarded channel between the workers and the
  batcher. A job is registered at admission (STAGED), becomes READY when its
  worker publishes it, and is popped by the batcher loop, or cancelled by a
  shed. Every transition is atomic under one lock, so a handoff is
  delivered once and its decode-side pages freed once, even when a shed
  races the worker's ``put``; a ``put`` for a job that is not STAGED (a
  replay) is refused.
- ``PrefillWorker``: one thread, one ``torch.cuda.Stream``, one staging
  page pool (``RESERVED_PAGES + n_pages`` pages in the server's KV dtype)
  and on a card one CUDA graph per chunk length (``servers/step_graph.
  capture_prefill_chunks`` on the worker's stream, in the worker's own graph
  memory pool, captured on the worker's thread before its first job). It
  runs the server's own prefill-chunk program (``_get_prefill_chunk``) with
  the chunk lengths local admission uses, so the KV it writes is local
  admission's, bit for bit. The written pages leave the staging pool as a
  COPY (the pool is reset and rewritten for the next job), a power-of-two
  page bucket made on the worker's stream; the ``torch.cuda.Event``
  recorded after it rides the ``Handoff``, and the batcher's stream waits on
  it before the import, so no host waits on the decode side. The worker also
  samples the first token from the last chunk's logits (``first_token``, the
  batcher's own sampler and key), so that sync happens on its thread.
- ``PrefillWorkerPool``: M workers behind least-backlog dispatch, the
  lowest index breaking ties.
- the network transport (``handoff_transport="network"``): a worker frames
  the bucket (``codec/framing.py``: one bulk copy off the card) and sends it
  length-prefixed over TCP to the batcher's ``HandoffReceiver``, which puts
  the tensors on the decode device in one copy each and publishes through the
  same ``TransferQueue.put``.

Devices. The split is ``parallel/mesh.DisaggregatedMesh``: the prefill
and decode devices as ``torch.device`` lists. The decode list holds the
server's device and decodes there: ``decode_devices=N`` names N entries
of it on one card, an explicit slice of several devices decodes on the
server's one, as the JAX batcher decodes on the default device inside its
slice, and the scaling snapshot counts the slice (what the autoscaler's
``min_decode_devices`` guard reads). ``prefill_devices=N`` (or ``prefill_workers=N``)
means N workers on the server's own device, each with its own stream,
staging pool and graphs, sharing the server's weights (``LLMServer.
_params_on`` returns the server's own tensors for its own device). This is
the one deliberate difference from the JAX package, which refuses
disaggregation on fewer than two devices. An explicit ``disagg_mesh`` may
name another card; its workers get one copy of the weights a device, as
the JAX package's ``_params_on`` makes. That path is not verified on a
one-card machine.

The flight recorder's handoff events (``PrefillRequest.record_events``,
set when the batcher records timelines): a worker stamps
``handoff_compute`` (its prefill's host wall, the first token's sync
included) and, on the device transport, ``handoff_transfer`` into the
``Handoff`` before it publishes it; on the network transport the frame's
metadata carries the worker's events and the receiver stamps
``handoff_transfer`` (decode and copy onto the card). Stamps are host
clock readings on this process's ``perf_counter``: no stamp waits on the
device.

The pool swap (``ContinuousBatcher.rebalance_disagg``, the autoscaler's
device actuator): a new ``PrefillWorkerPool`` is built on the batcher's
``TransferQueue``, each worker's stream, staging pool and chunk graphs made
on its own thread while the batcher's decode graphs replay; a failed build
closes what it made and raises, and the old pool serves on. After the swap
the old pool's ``close()`` lets each worker finish the jobs staged on it
and publish them into the same queue before its thread joins, then waits
on the worker's stream and drops its graphs, staging pool and buffers, so
no handed-off job is dropped and the old pool's device memory is free when
``close()`` returns (a worker whose thread outlived the join timeout keeps
its state).

The dense layout (``kv_cache_layout="dense"``): a worker holds one staging
row of the batcher's slot-pool geometry (``max_len`` positions and a trash
column, ``Transformer.init_slot_caches(1, max_len)``), reused job after job,
and runs the local dense admission's one-shot prefill into it
(``_get_prefill(1, plen, max_len)``, eager everywhere: the same program over
the same row shape, so the same KV bits); the handoff is a copy of the
prompt's ``plen`` columns, which the batcher inserts into the slot's row
(``runtime/batcher.insert_slot_row``) over either transport."""

from __future__ import annotations

import contextlib
import logging
import socket
import struct
import threading
import time
import warnings
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from seldon_core_tpu_torch.parallel.mesh import same_device

logger = logging.getLogger(__name__)

DISAGGREGATION_MODES = ("off", "remote_prefill")

# how a finished prefill's KV reaches the decode side: "device" hands the
# bucket over as tensors (the same card, or a copy to the decode card);
# "network" frames it over a socket to the batcher's HandoffReceiver
HANDOFF_TRANSPORTS = ("device", "network")

# one network handoff on the wire: an 8-byte little-endian length, then that
# many frame bytes. The length is bounded before any allocation
MAX_HANDOFF_FRAME_BYTES = 1 << 33  # 8 GiB

# TransferQueue record states (compared by identity)
_STAGED = "staged"        # registered; the worker has not finished yet
_READY = "ready"          # handoff published, waiting for the batcher
_CANCELLED = "cancelled"  # shed before the worker finished


def normalize_disaggregation(value) -> str:
    """Canonical disaggregation mode ("off" or "remote_prefill"); ValueError
    on anything else, so misconfiguration fails at load()."""
    v = str(value or "off").strip().lower()
    if v in ("off", "none", "no", "0", ""):
        return "off"
    if v in ("remote_prefill", "remote-prefill", "prefill", "disagg", "disaggregated"):
        return "remote_prefill"
    raise ValueError(f"unknown disaggregation {value!r}: expected one of {DISAGGREGATION_MODES}")


def staged_leaves(staged) -> List[torch.Tensor]:
    """The tensors of a staged bucket (a list of per-layer tuples)."""
    return [t for layer in staged for t in layer]


class PrefillRequest:
    """What a worker needs for one admission: the (already truncated)
    prompt, its bucket ``plen``, the page count the decode side allocated
    (``n_pages``), and the first-token key the batcher drew for it
    (``first_key``). With a radix hit, ``prefix_staged`` is the decode
    pool's exported bucket of the ``prefix_pages`` matched blocks
    (``prefix_len`` tokens) and ``prefix_event`` the event its export was
    recorded under: the worker imports it into its staging pool and
    computes only positions ``prefix_len..``. ``record_events``: stamp the
    flight recorder's handoff events into the Handoff."""

    __slots__ = ("job_id", "ids", "plen", "n_pages", "record_events", "prefix_len",
                 "prefix_pages", "prefix_staged", "prefix_event", "first_key")

    def __init__(self, job_id: int, ids: List[int], plen: int, n_pages: int = 0,
                 record_events: bool = False, prefix_len: int = 0, prefix_pages: int = 0,
                 prefix_staged: Any = None, prefix_event: Any = None, first_key: int = 0):
        self.job_id = job_id
        self.ids = list(ids)
        self.plen = int(plen)
        self.n_pages = int(n_pages)
        self.record_events = bool(record_events)
        self.prefix_len = int(prefix_len)
        self.prefix_pages = int(prefix_pages)
        self.prefix_staged = prefix_staged
        self.prefix_event = prefix_event
        self.first_key = int(first_key)


class Handoff:
    """One finished prefill, published by a worker (or the receiver): the
    staged page bucket on the decode device, the ``torch.cuda.Event`` it was
    written under (None on the CPU, or once the host already waited), the
    first sampled token and the key after it, the last position's logits
    (float32 host array), timing and bytes for the metrics. ``error``
    carries a worker-side failure instead of a payload: the batcher fails
    that request with it. ``events``: the flight recorder's (t, kind,
    fields) stamps of the worker (and the receiver), when the request asked
    for them."""

    __slots__ = ("job_id", "staged", "first_logits", "error", "prefill_s", "transfer_bytes",
                 "events", "first_token", "first_key", "event")

    def __init__(self, job_id: int, staged: Any = None,
                 first_logits: Optional[np.ndarray] = None,
                 error: Optional[BaseException] = None, prefill_s: float = 0.0,
                 transfer_bytes: int = 0, events: Optional[list] = None,
                 first_token: Optional[int] = None, first_key: Optional[int] = None,
                 event: Any = None):
        self.job_id = job_id
        self.staged = staged
        self.first_logits = first_logits
        self.error = error
        self.prefill_s = prefill_s
        self.transfer_bytes = transfer_bytes
        self.events = events or []
        self.first_token = first_token
        self.first_key = first_key
        self.event = event


class TransferQueue:
    """The exactly-once channel between the workers and the batcher (copied
    from the JAX package). All transitions atomic under ``self._lock``:

    - ``register(job_id)`` (batcher, at admission): STAGED;
    - ``put(handoff)`` (worker or receiver): STAGED -> READY; False when the
      job was cancelled meanwhile (the payload drops; the canceller freed
      the pages), unknown, or already READY (a replayed frame);
    - ``pop()`` (batcher loop): the oldest READY handoff, removed;
    - ``cancel(job_id)`` (batcher shed paths): READY -> the handoff (the
      caller frees the pages); STAGED -> marked cancelled, None (the caller
      frees the pages now; the worker's put will be refused); unknown or
      popped -> None (the slot owns the pages)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._state: Dict[int, str] = {}
        self._ready: deque = deque()  # Handoff records, arrival order
        self.handoffs_total = 0
        self.transfer_bytes_total = 0
        # ready notification (the batcher's loop wakeup): read under the
        # lock, called outside it, so it can never deadlock queue users
        self.on_ready: Optional[Any] = None

    def register(self, job_id: int) -> None:
        with self._lock:
            self._state[job_id] = _STAGED

    def put(self, handoff: Handoff) -> bool:
        """Publish a finished prefill; only a STAGED job becomes READY."""
        with self._lock:
            st = self._state.get(handoff.job_id)
            if st is not _STAGED:
                if st is _CANCELLED:
                    del self._state[handoff.job_id]
                return False
            self._state[handoff.job_id] = _READY
            self._ready.append(handoff)
            self.handoffs_total += 1
            self.transfer_bytes_total += int(handoff.transfer_bytes)
            cb = self.on_ready
        if cb is not None:
            try:
                cb()
            except Exception:  # a wakeup hook must never kill a worker
                logger.exception("transfer-queue on_ready hook failed")
        return True

    def pop(self) -> Optional[Handoff]:
        """The oldest READY handoff, or None; its pages now belong to its slot."""
        with self._lock:
            if not self._ready:
                return None
            h = self._ready.popleft()
            self._state.pop(h.job_id, None)
            return h

    def cancel(self, job_id: int) -> Optional[Handoff]:
        """Shed a job: the handoff if it was READY, else None."""
        with self._lock:
            st = self._state.get(job_id)
            if st is _READY:
                found = None
                for i, h in enumerate(self._ready):
                    if h.job_id == job_id:
                        found = h
                        del self._ready[i]
                        break
                del self._state[job_id]
                return found
            if st is _STAGED:
                self._state[job_id] = _CANCELLED
            return None

    def ready_depth(self) -> int:
        with self._lock:
            return len(self._ready)

    def depth(self) -> int:
        """Jobs registered and not yet consumed (staged + ready)."""
        with self._lock:
            return len(self._state)

    def stats(self):
        """(handoffs_total, transfer_bytes_total, staged + ready depth): one
        consistent snapshot for the scrape."""
        with self._lock:
            return self.handoffs_total, self.transfer_bytes_total, len(self._state)


def _host_to(device: torch.device, arr) -> torch.Tensor:
    """A host array (numpy, or a torch CPU tensor) as a tensor on ``device``
    in one copy, on the current stream (asynchronous from pinned memory)."""
    if not torch.is_tensor(arr):
        with warnings.catch_warnings():  # a view of a read-only frame: only read
            warnings.simplefilter("ignore", UserWarning)
            arr = torch.from_numpy(arr)
    return arr.to(device, non_blocking=True)


class PrefillWorker:
    """One prefill worker: a thread that owns a stream, a staging page pool,
    fixed chunk buffers and (on a card) the chunk graphs over them, built on
    its own thread before its first job (the constructor waits for that and
    raises what it raised); under the dense layout a staging row instead,
    and no graphs (module docstring). Its jobs come through ``submit``; each publishes
    one handoff. The backlog and closing flag live under ``self._cond``;
    everything else is the worker thread's. ``replays`` / ``eager_runs``
    count its chunks as graph replays (a card) and eager program runs (the
    CPU)."""

    def __init__(self, server: Any, queue: TransferQueue, device: Any, decode_device: Any, *,
                 layout: str, max_len: int, page_size: int = 0, n_pages: int = 0,
                 prefill_chunk: int = 0, chunks: Sequence[int] = (),
                 name: str = "prefill-worker", transport: str = "device",
                 receiver_addr: Optional[tuple] = None):
        if transport not in HANDOFF_TRANSPORTS:
            raise ValueError(f"unknown handoff transport {transport!r}: expected one of "
                             f"{HANDOFF_TRANSPORTS}")
        if transport == "network" and receiver_addr is None:
            raise ValueError("network handoff transport needs the decode side's "
                             "HandoffReceiver address")
        if layout not in ("paged", "dense"):
            raise ValueError(f"unknown kv_cache_layout {layout!r} for a prefill worker")
        self.server = server
        self.queue = queue
        self.device = torch.device(device)
        self.decode_device = torch.device(decode_device)
        self.layout = layout
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        self.prefill_chunk = int(prefill_chunk)
        self.chunks = tuple(sorted(set(int(c) for c in chunks))) or (self.prefill_chunk,)
        self.name = name
        self.transport = transport
        self.receiver_addr = receiver_addr
        self.replays = 0
        self.eager_runs = 0
        self._sock = None  # persistent frame socket, worker thread only
        self._cond = threading.Condition()
        self._backlog: deque = deque()
        self._closing = False
        self._params = None
        self._staging = None
        self._stream: Optional[torch.cuda.Stream] = None
        self._graphs: Dict[int, Any] = {}
        self._ready = threading.Event()
        self._start_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()
        self._ready.wait()
        if self._start_error is not None:
            self.close()
            raise self._start_error

    # -- caller side ---------------------------------------------------
    def submit(self, req: PrefillRequest) -> None:
        with self._cond:
            if self._closing:
                raise RuntimeError(f"{self.name} is closed")
            self._backlog.append(req)
            self._cond.notify()

    def backlog_depth(self) -> int:
        with self._cond:
            return len(self._backlog)

    def close(self, timeout_s: float = 30.0) -> None:
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        # bounded: a wedged job must not hang server shutdown
        self._thread.join(timeout=timeout_s)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if not self._thread.is_alive():
            self._release()

    def _release(self) -> None:
        """Free the worker's device state once its thread is gone: its
        stream is waited on (its last chunk and bucket copy have run), then
        the graphs (and with them their memory pool), the staging pool and
        the fixed buffers are dropped."""
        if self._stream is not None:
            self._stream.synchronize()
        self._graphs = {}
        self._staging = self._params = None
        self._row = self._tokens = self._pos = self._temp = None

    # -- worker side ---------------------------------------------------
    @contextlib.contextmanager
    def _on_stream(self) -> Iterator[None]:
        """The worker's device and stream current (on a card), grad off
        (grad mode is per thread)."""
        with torch.no_grad():
            if self.device.type != "cuda":
                yield
                return
            with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
                yield

    def _next_job(self) -> Optional[PrefillRequest]:
        with self._cond:
            while not self._backlog and not self._closing:
                self._cond.wait(timeout=0.5)
            if self._backlog:
                return self._backlog.popleft()
            return None  # closing and drained

    def _run(self) -> None:
        try:
            if self.device.type == "cuda":
                self._stream = torch.cuda.Stream(device=self.device)
            with self._on_stream():
                self._build_state()
        except BaseException as e:  # noqa: BLE001 — raised by the constructor
            self._start_error = e
            self._ready.set()
            return
        self._ready.set()
        while True:
            req = self._next_job()
            if req is None:
                return
            try:
                with self._on_stream():
                    handoff = self._prefill_one(req)
            except BaseException as e:  # noqa: BLE001 — the worker must not die
                logger.exception("prefill worker %s failed job %d", self.name, req.job_id)
                handoff = Handoff(req.job_id, error=e)
            self._publish(handoff)
            handoff = None   # the bucket is the batcher's now: hold none of it

    def _build_state(self) -> None:
        """The weights (the server's own on its device), the staging pool,
        the fixed chunk buffers and, on a card, one graph per chunk length
        on this thread and stream, in one pool of the worker's own (a
        capture that fails raises)."""
        from seldon_core_tpu_torch.models.transformer import NULL_PAGE, PAD_POS, RESERVED_PAGES
        from seldon_core_tpu_torch.servers.step_graph import capture_prefill_chunks

        server, dev = self.server, self.device
        self._params = server._params_on(dev)
        # the batcher's temperature form (a 0-dim tensor on this device, or
        # None for greedy), so the first token samples as local admission's
        self._temp = (torch.full((), float(server.temperature), dtype=torch.float32, device=dev)
                      if float(server.temperature) > 0 else None)
        if self.layout == "dense":
            self._staging = self._params.init_slot_caches(1, self.max_len,
                                                          server.kv_cache_dtype, device=dev)
            return
        self._staging = server._get_staging_pool_init(RESERVED_PAGES + self.n_pages,
                                                      self.page_size)(dev)
        cmax = max(self.chunks)
        self._row = torch.full((1, self.n_pages), NULL_PAGE, dtype=torch.int32, device=dev)
        self._tokens = torch.zeros((1, cmax), dtype=torch.int64, device=dev)
        self._pos = torch.full((1, cmax), PAD_POS, dtype=torch.int32, device=dev)
        if dev.type == "cuda":
            self._graphs = capture_prefill_chunks(server, self.chunks, self._staging, self._row,
                                                  self._tokens, self._pos, stream=self._stream)

    def graphs(self) -> Dict[int, Any]:
        """Chunk length -> this worker's captured graph (empty off the card)."""
        return dict(self._graphs)

    def staging_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in staged_leaves(self._staging))

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A small host array on the worker's device in stream order (a
        fresh pinned copy each call, as the batcher stages its inputs)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _prefill_one(self, req: PrefillRequest) -> Handoff:
        from seldon_core_tpu_torch.runtime.flight import EV_HANDOFF_COMPUTE, EV_HANDOFF_TRANSFER

        t0 = time.perf_counter()
        prefill = self._prefill_paged if self.layout == "paged" else self._prefill_dense
        staged, first_logits, first, key = prefill(req)
        t1 = time.perf_counter()
        events = ([(t1, EV_HANDOFF_COMPUTE, {"worker": self.name, "dur_s": t1 - t0})]
                  if req.record_events else [])
        if self.transport == "network":
            # the bucket stays on this device: _frame_handoff takes it off
            # the card in one bulk copy and ships it (the receiver stamps
            # the transfer)
            return Handoff(req.job_id, staged=staged, first_logits=first_logits,
                           prefill_s=t1 - t0, first_token=first, first_key=key, events=events)
        event = None
        if not same_device(self.device, self.decode_device):
            staged = [tuple(t.to(self.decode_device, non_blocking=True) for t in layer)
                      for layer in staged]
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        nbytes = sum(t.numel() * t.element_size() for t in staged_leaves(staged))
        t2 = time.perf_counter()
        if req.record_events:
            # the enqueue of the move (none on the same card): the decode
            # stream waits on the event, no host does
            events.append((t2, EV_HANDOFF_TRANSFER, {"bytes": nbytes, "dur_s": t2 - t1}))
        return Handoff(req.job_id, staged=staged, first_logits=first_logits,
                       prefill_s=t2 - t0, transfer_bytes=nbytes, first_token=first,
                       first_key=key, event=event, events=events)

    def _chunk(self, C: int, staging) -> torch.Tensor:
        """One chunk of ``C`` tokens through the staged row and buffers: a
        replay of its graph on a card (a length without one raises), the
        eager program on the CPU."""
        if self.device.type == "cuda":
            graph = self._graphs.get(C)
            if graph is None:
                raise RuntimeError(f"no prefill graph for a chunk of {C} tokens (captured: "
                                   f"{sorted(self._graphs)})")
            self.replays += 1
            return graph.replay()
        self.eager_runs += 1
        return self.server._get_prefill_chunk(C, self.n_pages, device=self.device)(
            staging, self._row, self._tokens[:, :C], self._pos[:, :C])

    def _prefill_paged(self, req: PrefillRequest):
        """Chunked prefill into the staging pool through the staging row:
        the sequence's pages are ``RESERVED_PAGES..``, their positions reset
        first (the pool is reused job after job). With a radix hit the
        exported prefix bucket is imported into the leading pages (after
        the worker's stream waited for its export) and the chunks start at
        ``prefix_len``. Returns (the bucket: a copy of rows ``n_pre ..
        n_pre + RESERVED_PAGES + b`` of every tensor, b the power-of-two
        cover of the pages this worker wrote; the last position's logits
        as a float32 host array; the first token; the key after it)."""
        from seldon_core_tpu_torch.models.transformer import NULL_PAGE, PAD_POS, RESERVED_PAGES
        from seldon_core_tpu_torch.runtime.batcher import pow2_bucket
        from seldon_core_tpu_torch.servers.llmserver import first_token

        server, staging, R = self.server, self._staging, RESERVED_PAGES
        ids = req.ids
        L = len(ids)
        n0 = req.n_pages or -(-L // self.page_size)
        n_pre = min(req.prefix_pages, n0) if req.prefix_staged is not None else 0
        seq = np.arange(R, R + n0, dtype=np.int64)
        seq_t = self._to_device(seq)
        for layer in staging:
            layer[-1].index_fill_(0, seq_t, PAD_POS)
        row = np.full((1, self.n_pages), NULL_PAGE, np.int32)
        row[0, :n0] = seq
        self._row.copy_(self._to_device(row))
        if n_pre:
            bucket = req.prefix_staged
            if req.prefix_event is not None:
                torch.cuda.current_stream(self.device).wait_event(req.prefix_event)
            if not same_device(bucket[0][0].device, self.device):
                bucket = [tuple(t.to(self.device) for t in layer) for layer in bucket]
            elif self.device.type == "cuda":
                # made on the batcher's stream, read on this one
                for t in staged_leaves(bucket):
                    t.record_stream(torch.cuda.current_stream(self.device))
            pre_row = np.full((self.n_pages,), NULL_PAGE, np.int64)
            pre_row[:n_pre] = np.arange(R, R + n_pre)
            server._get_handoff_import(self.n_pages, bucket[0][0].shape[0] - R)(
                staging, bucket, pre_row, n_pre)
            req.prefix_staged = bucket = None   # enqueued: the export can go
        C = min(self.prefill_chunk, req.plen) or req.plen
        logits, n, start = None, 0, n_pre * self.page_size
        while start < L:
            part = ids[start:start + C]
            n = len(part)
            toks = np.zeros((1, C), np.int64)
            pos = np.full((1, C), PAD_POS, np.int32)
            toks[0, :n] = part
            pos[0, :n] = np.arange(start, start + n)
            self._tokens[:, :C].copy_(self._to_device(toks))
            self._pos[:, :C].copy_(self._to_device(pos))
            logits = self._chunk(C, staging)
            start += n
        n_suffix = n0 - n_pre
        b = pow2_bucket(n_suffix, self.n_pages - n_pre)
        staged = [tuple(t[n_pre:n_pre + R + b].clone() for t in layer) for layer in staging]
        row_logits = logits[0, n - 1]
        # the one host sync of a job, on this thread: the first token, and
        # the logits the frame carries
        first, key = first_token(row_logits, req.first_key, self._temp, server.top_k)
        return staged, row_logits.float().cpu().numpy(), first, key

    def _prefill_dense(self, req: PrefillRequest):
        """The dense admission's one-shot prefill (the JAX package's
        ``_prefill_dense``) into the staging row, which the program resets
        first, eagerly. Returns (the bucket: a copy of the row's first
        ``plen`` columns of every tensor; the last position's logits as a
        float32 host array; the first token; the key after it)."""
        from seldon_core_tpu_torch.models.transformer import PAD_POS
        from seldon_core_tpu_torch.servers.llmserver import first_token

        L = len(req.ids)
        toks = np.zeros((1, req.plen), np.int64)
        pos = np.full((1, req.plen), PAD_POS, np.int32)
        toks[0, :L] = req.ids
        pos[0, :L] = np.arange(L)
        self.eager_runs += 1
        logits = self.server._get_prefill(1, req.plen, self.max_len, device=self.device)(
            self._staging, self._to_device(toks), self._to_device(pos))
        staged = [tuple(t[:, :req.plen].clone() for t in layer) for layer in self._staging]
        row_logits = logits[0, L - 1]
        first, key = first_token(row_logits, req.first_key, self._temp, self.server.top_k)
        return staged, row_logits.float().cpu().numpy(), first, key

    # -- network transport (worker side) -------------------------------
    def _publish(self, handoff: Handoff) -> None:
        """Device transport (and every error) goes straight into the queue;
        the network transport frames the bucket and sends it to the
        batcher's ``HandoffReceiver``, which runs the same ``put``."""
        if self.transport != "network" or handoff.error is not None:
            self.queue.put(handoff)
            return
        try:
            with self._on_stream():
                buffers = self._frame_handoff(handoff)
            self._send_frame(buffers)
        except BaseException as e:  # noqa: BLE001 — the worker must not die
            logger.exception("prefill worker %s could not ship job %d over the network "
                             "handoff", self.name, handoff.job_id)
            self.queue.put(Handoff(handoff.job_id, error=e))

    def _frame_handoff(self, handoff: Handoff) -> List[Any]:
        """One handoff as a frame, as the buffers it is made of
        (``framing.encode_frame_parts``): the bucket's skeleton and the
        job's metadata in the JSON section, the pages and first-token
        logits as raw tensors (the bucket leaves the card in one bulk
        copy)."""
        from seldon_core_tpu_torch.codec import framing

        skel, leaves = framing.tree_skeleton(handoff.staged)
        tensors = list(leaves)
        fl_ref = None
        if handoff.first_logits is not None:
            fl_ref = len(tensors)
            tensors.append(handoff.first_logits)
        meta = {"kind": "KVHandoff", "job_id": handoff.job_id, "prefill_s": handoff.prefill_s,
                "skeleton": skel, "first_logits_ref": fl_ref,
                "record_events": bool(handoff.events),
                "events": [[t, kind, fields] for t, kind, fields in handoff.events],
                "first_token": handoff.first_token, "first_key": handoff.first_key}
        return framing.encode_frame_parts(meta, tensors, path="handoff")

    def _send_frame(self, buffers: Sequence[Any]) -> None:
        """One frame (its buffers, written in order, never joined) behind
        its 8-byte length over the persistent socket, reconnecting once on
        a broken pipe (the queue refuses a replayed job)."""
        head = struct.pack("<Q", sum(memoryview(b).nbytes for b in buffers))
        for attempt in (0, 1):
            try:
                if self._sock is None:
                    self._sock = socket.create_connection(self.receiver_addr, timeout=30.0)
                    self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                for b in (head, *buffers):
                    self._sock.sendall(b)
                return
            except OSError:
                if self._sock is not None:
                    try:
                        self._sock.close()
                    finally:
                        self._sock = None
                if attempt:
                    raise


class TruncatedStream(ConnectionError):
    """Mid-message EOF, carrying the bytes read so far: the metadata leads
    the frame, so the receiver can usually still resolve the job."""

    def __init__(self, msg: str, partial: bytes = b""):
        super().__init__(msg)
        self.partial = partial


# the bounded read for a frame the receiver refuses to take (declared length
# over MAX_HANDOFF_FRAME_BYTES): enough for the header, table and metadata
HANDOFF_META_PROBE_BYTES = 1 << 20


def _recv_exact(conn, n: int, into: Optional[memoryview] = None):
    """Exactly ``n`` bytes from a socket (into ``into``, a writable buffer
    of ``n`` bytes, when given, which is then returned), or None on a clean
    EOF; an EOF mid-message raises TruncatedStream."""
    view = memoryview(into if into is not None else bytearray(n)).cast("B")
    got = 0
    while got < n:
        k = conn.recv_into(view[got:], min(16 << 20, n - got))
        if not k:
            if got:
                raise TruncatedStream(f"handoff stream truncated: wanted {n} bytes, "
                                      f"got {got}", partial=bytes(view[:got]))
            return None
        got += k
    return view if into is not None else bytes(view)


class HandoffReceiver:
    """The decode side of the network handoff: a TCP listener on
    ``host`` whose reader threads decode frames, put each tensor on the
    decode device in one copy (on the receiver's own stream, whose event
    rides the Handoff), and publish through the same ``TransferQueue.put``
    as the device transport. A frame whose payload is bad but whose
    metadata decodes resolves its job with an error handoff; one whose
    metadata is unreadable is logged and dropped; the length prefix is
    checked before any allocation."""

    def __init__(self, queue: TransferQueue, device: Any, host: str = "127.0.0.1"):
        self.queue = queue
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(device=self.device) if self.device.type == "cuda"
                        else None)
        self._lock = threading.Lock()
        self.network_bytes_total = 0  # wire payload bytes, under _lock
        self._closing = False
        self._conns: List[Any] = []
        self._threads: List[threading.Thread] = []
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.bind((host, 0))
        self._listener.listen(16)
        self.addr = self._listener.getsockname()
        t = threading.Thread(target=self._accept_loop, name="handoff-receiver", daemon=True)
        self._threads.append(t)
        t.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed by close()
            with self._lock:
                if self._closing:
                    conn.close()
                    return
                self._conns.append(conn)
                t = threading.Thread(target=self._read_loop, args=(conn,),
                                     name="handoff-reader", daemon=True)
                self._threads.append(t)
            t.start()

    def _read_loop(self, conn) -> None:
        try:
            while True:
                head = _recv_exact(conn, 8)
                if head is None:
                    return
                (n,) = struct.unpack("<Q", head)
                if n > MAX_HANDOFF_FRAME_BYTES:
                    # refuse without leaking the job: a BOUNDED probe (never
                    # the declared length) usually still holds the metadata
                    probe = b""
                    try:
                        probe = _recv_exact(conn, min(n, HANDOFF_META_PROBE_BYTES)) or b""
                    except TruncatedStream as te:
                        probe = te.partial
                    except (OSError, ConnectionError):
                        pass
                    self._refuse(probe, f"frame declares {n} bytes "
                                        f"(cap {MAX_HANDOFF_FRAME_BYTES})")
                    return
                try:
                    payload = _recv_exact(conn, n, into=self._frame_buffer(n))
                except TruncatedStream as te:
                    self._refuse(te.partial, str(te))
                    return
                if payload is None:
                    return
                handoff = self._materialize(payload)
                if handoff is not None:
                    self.queue.put(handoff)
        except (OSError, ConnectionError) as e:
            with self._lock:
                closing = self._closing
            if not closing:
                logger.warning("handoff connection dropped: %s", e)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _frame_buffer(self, n: int) -> memoryview:
        """Where a frame of ``n`` bytes is received: pinned host memory when
        the decode device is a card (its tensors then reach the card by
        asynchronous copies), else a bytearray."""
        if self._stream is None:
            return memoryview(bytearray(n))
        return memoryview(torch.empty((n,), dtype=torch.uint8, pin_memory=True).numpy())

    def _materialize(self, payload) -> Optional[Handoff]:
        """One frame -> one Handoff with the bucket on the decode device.
        On a card the copies run on the receiver's stream and this thread
        waits for them (so the frame's buffer can go); their event rides
        the Handoff. A decode failure is an error handoff when the metadata
        (the job id) survives, else None (dropped). With ``record_events`` in
        the metadata, the worker's events ride on and the receiver stamps
        ``handoff_transfer`` (decode and copies, this thread's wall)."""
        from seldon_core_tpu_torch.codec import framing
        from seldon_core_tpu_torch.runtime.flight import EV_HANDOFF_TRANSFER

        t0 = time.perf_counter()
        try:
            meta, tensors = framing.decode_frame(payload, path="handoff")
            if meta.get("kind") != "KVHandoff":
                raise framing.FrameError(f"expected a KVHandoff frame, got {meta.get('kind')!r}")
            skel = meta["skeleton"]
            fl_ref = meta.get("first_logits_ref")
            first_logits = None
            if fl_ref is not None:
                first_logits = np.array(tensors[fl_ref])   # a copy: the frame can go
            event = None
            if self._stream is not None:
                with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
                    moved = [_host_to(self.device, t) for t in tensors]
                    event = torch.cuda.Event()
                    event.record()
                event.synchronize()
            else:
                moved = [_host_to(self.device, t) for t in tensors]
            staged = framing.tree_unskeleton(skel, moved)
            t1 = time.perf_counter()
            events = [(e[0], e[1], e[2]) for e in meta.get("events", ())]
            if meta.get("record_events"):
                events.append((t1, EV_HANDOFF_TRANSFER, {"bytes": len(payload), "dur_s": t1 - t0}))
            with self._lock:
                self.network_bytes_total += len(payload)
            return Handoff(meta["job_id"], staged=staged, first_logits=first_logits,
                           prefill_s=meta.get("prefill_s", 0.0), transfer_bytes=len(payload),
                           first_token=meta.get("first_token"), first_key=meta.get("first_key"),
                           event=event, events=events)
        except Exception as e:  # noqa: BLE001 — the receiver must not die
            job_id = None
            try:
                meta, _ = framing.decode_frame(payload, meta_only=True, path="handoff")
                job_id = meta.get("job_id")
            except Exception:  # noqa: BLE001
                pass
            if job_id is None:
                logger.exception("dropping undecodable handoff frame (no recoverable job_id)")
                return None
            logger.exception("handoff frame for job %s failed to decode; resolving with error",
                             job_id)
            return Handoff(job_id, error=e)

    def _refuse(self, prefix: bytes, why: str) -> None:
        """Resolve a frame the receiver will never read whole (oversized
        declared length, truncation): the metadata leads the frame, so the
        prefix usually decodes with ``meta_only=True`` and the job gets an
        error handoff; without a job id it is logged and dropped."""
        from seldon_core_tpu_torch.codec import framing

        job_id = None
        try:
            meta, _ = framing.decode_frame(prefix, meta_only=True, path="handoff")
            if meta.get("kind") == "KVHandoff":
                job_id = meta.get("job_id")
        except Exception:  # noqa: BLE001 — the prefix is hostile input
            pass
        if job_id is None:
            logger.error("dropping unresolvable handoff frame (%s; no recoverable job_id in %d "
                         "probe bytes)", why, len(prefix))
            return
        logger.error("handoff frame for job %s refused (%s); resolving with error", job_id, why)
        self.queue.put(Handoff(job_id, error=ConnectionError(why)))

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"handoff_network_bytes_total": self.network_bytes_total}

    def close(self, timeout_s: float = 5.0) -> None:
        with self._lock:
            self._closing = True
            conns = list(self._conns)
        for c in conns:
            # close() from another thread does not interrupt a blocked
            # recv(); shutdown() does
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        # a blocked accept() survives listener.close(); a self-connect wakes it
        try:
            with socket.create_connection(self.addr, timeout=1.0):
                pass
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=timeout_s)


class PrefillWorkerPool:
    """M prefill workers behind least-backlog dispatch (the lowest index
    breaks ties), publishing into one TransferQueue (``queue``, or a new
    one). Workers are built one after another, each ready (graphs
    captured) before the next starts."""

    def __init__(self, server: Any, devices: Sequence, decode_device: Any, *, layout: str,
                 max_len: int, page_size: int = 0, n_pages: int = 0, prefill_chunk: int = 0,
                 chunks: Sequence[int] = (), queue: Optional[TransferQueue] = None,
                 transport: str = "device", receiver_addr: Optional[tuple] = None):
        self.queue = queue if queue is not None else TransferQueue()
        self.transport = transport
        self.receiver_addr = receiver_addr
        self.workers: List[PrefillWorker] = []
        try:
            for i, dev in enumerate(devices):
                self.workers.append(PrefillWorker(
                    server, self.queue, dev, decode_device, layout=layout, max_len=max_len,
                    page_size=page_size, n_pages=n_pages, prefill_chunk=prefill_chunk,
                    chunks=chunks, name=f"prefill-worker-{i}", transport=transport,
                    receiver_addr=receiver_addr))
        except BaseException:
            self.close()
            raise

    def submit(self, req: PrefillRequest) -> None:
        self.queue.register(req.job_id)
        _, w = min(enumerate(self.workers), key=lambda iw: (iw[1].backlog_depth(), iw[0]))
        w.submit(req)

    def backlog_depth(self) -> int:
        return sum(w.backlog_depth() for w in self.workers)

    def close(self, timeout_s: float = 30.0) -> None:
        for w in self.workers:
            w.close(timeout_s=timeout_s)


__all__ = ["DISAGGREGATION_MODES", "HANDOFF_META_PROBE_BYTES", "HANDOFF_TRANSPORTS",
           "Handoff", "HandoffReceiver", "MAX_HANDOFF_FRAME_BYTES", "PrefillRequest",
           "PrefillWorker", "PrefillWorkerPool", "TransferQueue", "TruncatedStream",
           "normalize_disaggregation", "same_device", "staged_leaves"]
