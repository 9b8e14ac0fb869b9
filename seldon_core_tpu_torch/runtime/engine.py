"""In-process inference-graph engine of the port: ``seldon_core_tpu/runtime/
engine.py``'s ``GraphEngine`` over local nodes.

The reference orchestrator's graph semantics
(`engine/src/main/java/io/seldon/engine/predictors/PredictiveUnitBean.java:81-237`):

    per node: transformInput -> route (-1 = all children) -> children ->
              aggregate -> transformOutput
    meta: merge tags, accumulate metrics, record routing + requestPath
    feedback: deliver to the node, then replay only down the routed branch

Every node is a direct call in this process, and the graph is built once,
not per request. A router-free subtree of two or more units whose
components all expose ``torch_fn()`` is composed into one function on the
engine's device (``_try_fuse``): the request's array is staged to the
device once, the children's outputs are stacked and reduced there, and
the result comes back to the host once. ``_fused_calls`` counts its runs.

A graph of local synchronous nodes is driven without an event loop
(``predict_sync``); one that has an asynchronous component runs on
``asyncio``, its children fanned out concurrently. A unit with an
``endpoint`` is a remote node (``runtime/remote.RemoteComponent``, an
asynchronous component); a list of components under one name is one
``ReplicaSet``: replicas behind least-loaded, prefix-aware dispatch.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextvars
import inspect
import logging
import queue
import secrets
import threading
import time
import weakref
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.codec.response import response_meta
from seldon_core_tpu_torch.codec.staging import stage_to_device
from seldon_core_tpu_torch.components import dispatch
from seldon_core_tpu_torch.components.builtin import make_builtin
from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.graph import (PredictiveUnit, PredictorSpec,
                                                   UnitImplementation, UnitMethod, UnitType)
from seldon_core_tpu_torch.contracts.payload import (Feedback, Meta, SeldonError, SeldonMessage,
                                                     SeldonMessageList)
from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.runtime.resilience import (BreakerOpen, CircuitBreaker, Deadline,
                                                      ResilienceConfig, ResumeJournal,
                                                      ResumeMarker, RetryBudget, ShedError,
                                                      current_deadline, deadline_scope,
                                                      failure_counts_for_breaker)
from seldon_core_tpu_torch.tracing import get_tracer

logger = logging.getLogger(__name__)

TAG_PARTIAL_RESPONSE = "seldon.io/partial-response"
TAG_DROPPED_BRANCHES = "seldon.io/dropped-branches"
TAG_REROUTED = "seldon.io/rerouted"

class _Suspended(Exception):
    """A graph coroutine suspended on real async work although
    ``has_async_nodes`` is False: the detection missed an async component
    (a sync method returning an awaitable, an async ``__call__``). Callers
    degrade to the event-loop path."""


def _drive_sync(coro):
    """Run a coroutine that never truly suspends (every await is another
    such coroutine) to its end without an event loop."""
    try:
        coro.send(None)
    except StopIteration as stop:
        return stop.value
    coro.close()
    raise _Suspended()


_METHODS = ("predict", "transform_input", "transform_output", "route", "aggregate",
            "send_feedback", "predict_raw", "transform_input_raw", "transform_output_raw",
            "route_raw", "aggregate_raw", "send_feedback_raw")


def _is_async_component(comp) -> bool:
    """Does this component suspend for real (the ``is_async`` marker, or
    any ``async def`` method)?"""
    if comp is None:
        return False
    if getattr(comp, "is_async", False):
        return True
    return any(inspect.iscoroutinefunction(getattr(comp, name, None)) for name in _METHODS)


def make_puid() -> str:
    """Request id of the reference's SecureRandom 130-bit class
    (`service/PredictionService.java:77-83`)."""
    return secrets.token_hex(16)


def replica_load(component: Any) -> Tuple[float, float]:
    """A replica's load for least-loaded dispatch, from signals the batcher
    already keeps: first the work ahead of a new request (queued requests
    plus occupied or prefilling slots), then the page pool's in-use
    fraction. A component without a batcher scores (0, 0)."""
    svc = getattr(component, "_batcher_service", None)
    if svc is None:
        return (0.0, 0.0)
    from seldon_core_tpu_torch.models.transformer import RESERVED_PAGES

    b = svc.batcher
    queued = len(b._pending) + sum(1 for s in b._slots if s.active or s.prefilling)
    total, in_use, _ = b._allocator.stats()
    return (float(queued), in_use / max(total - RESERVED_PAGES, 1))


class _DispatchPool:
    """Up to ``max_workers`` daemon threads running submitted calls, each
    call's Future returned at once (``ThreadPoolExecutor``'s contract). A
    thread starts only when no worker is idle. Daemon threads: a fleet
    generation still waiting on a replica never holds up the interpreter's
    exit. The workers hold no reference to the pool, nor to a call once it
    has run, and they end when the pool is collected, so a dropped fleet's
    replicas (and their device memory) go with it."""

    def __init__(self, max_workers: int, name: str):
        self.max_workers = int(max_workers)
        self.name = name
        self._work: queue.SimpleQueue = queue.SimpleQueue()
        self._idle = threading.Semaphore(0)
        self._lock = threading.Lock()
        self._threads = [0]
        weakref.finalize(self, _stop_workers, self._work, self._threads)

    def submit(self, fn: Callable, *args: Any) -> Future:
        fut: Future = Future()
        self._work.put((fut, fn, args))
        if not self._idle.acquire(blocking=False):
            with self._lock:
                if self._threads[0] < self.max_workers:
                    self._threads[0] += 1
                    threading.Thread(target=_dispatch_worker, args=(self._work, self._idle),
                                     daemon=True,
                                     name=f"{self.name}_{self._threads[0] - 1}").start()
        return fut


def _dispatch_worker(work: queue.SimpleQueue, idle: threading.Semaphore) -> None:
    while True:
        item = work.get()
        if item is None:
            return  # the pool was collected
        fut, fn, args = item
        if fut.set_running_or_notify_cancel():
            try:
                fut.set_result(fn(*args))
            except BaseException as e:  # noqa: BLE001 — the caller's to see
                fut.set_exception(e)
        del item, fut, fn, args  # hold nothing of the call while idle
        idle.release()


def _stop_workers(work: queue.SimpleQueue, threads: List[int]) -> None:
    for _ in range(threads[0]):
        work.put(None)


class _ResumeEntry:
    """One fleet generation's recovery record: what re-admits it on a
    surviving replica (its identity, the pinned seed, the tokenized prompt)
    and the tokens DELIVERED so far, whose count is also the number of
    splits to fast-forward its key by (the chain takes one a token). Batcher
    threads append while the fleet's retry loop reads: every access goes
    through ``ResumeJournal``, which holds the lock."""

    __slots__ = ("prompt_ids", "max_new", "seed", "tenant", "slo_class", "adapter", "tokens")

    def __init__(self, prompt_ids, max_new, seed, tenant, slo_class, adapter):
        self.prompt_ids = prompt_ids
        self.max_new = int(max_new)
        self.seed = seed
        self.tenant = tenant
        self.slo_class = slo_class
        self.adapter = adapter
        self.tokens: List[int] = []


class ReplicaSet(SeldonComponent):
    """N identical replicas behind one dispatcher, the JAX package's
    ``ReplicaSet`` (the in-process form of the reference's scaled
    Deployment behind the engine's service). A unit whose registered
    component is a list resolves to one. Each request goes to the replica
    that holds the longest cached prefix of its prompt (``pick_for``), then
    the least loaded (``replica_load``), then the lowest index, so dispatch
    is deterministic under equal load.

    Membership: ``add_replica`` attaches a replica; ``drain_replica`` takes
    one out of dispatch at once while it finishes its queued and in-flight
    work; ``collect_drained`` detaches it (and closes and forgets its
    batcher service) once it has been seen idle on two sweeps in a row, so a request picked just
    before the drain is never closed under. Membership changes under a
    lock; dispatch works on a snapshot.

    The transports reach it as a batcher service (``get_batcher_service``
    returns the fleet itself): ``submit`` runs one fleet generation on a
    dispatch thread and returns its Future. ``llm_stats`` merges the
    replicas' for the scrape and adds the fleet's own ``fleet_*`` tallies.

    Fault tolerance. ``check_health`` ejects a replica whose batcher loop
    crashed (``batcher.crashed``) or stopped stamping its heartbeat while
    its thread lives (quarantine, unlike a drain: a dead loop cannot
    drain). Each replica has a breaker (three consecutive infrastructure
    failures eject it too); ``reinstate_after_s`` later a half-open probe
    sends it real traffic, which restarts its loop, and a success
    reinstates it. Every fleet generation is journaled token by token
    (``ResumeJournal``); when its replica dies it re-admits on a survivor
    with the prompt and the delivered tokens as its prompt and its key
    fast-forwarded by their count, so the client's tokens equal an
    unfaulted run's and none is delivered twice; a ``ResumeMarker`` tells
    a stream where. Recoveries draw from ``retry_budget``; a spent budget
    sheds 503 with ``Retry-After``."""

    is_fleet = True

    def __init__(self, replicas: List[SeldonComponent]):
        super().__init__()
        if not replicas:
            raise SeldonError("ReplicaSet needs >= 1 replica", status_code=500)
        self.replicas = list(replicas)
        self._draining: List[SeldonComponent] = []
        # replicas seen idle on the previous collect sweep (by id)
        self._idle_once: set = set()
        self._lock = threading.Lock()
        # one collect sweep at a time: two overlapping sweeps would count as
        # two idle sightings an instant apart
        self._collect_guard = threading.Lock()
        # health: the clock the heartbeat test and the breakers read
        # (injectable, so a test moves time by hand), the heartbeat age that
        # counts as wedged (generous: a device step may block a turn), and
        # the quarantine before a half-open probe
        self.clock: Callable[[], float] = time.monotonic
        self.heartbeat_timeout_s: float = 30.0
        self.reinstate_after_s: float = 5.0
        self._health: Dict[int, CircuitBreaker] = {}  # id(replica) -> breaker
        self._ejected: List[SeldonComponent] = []
        self._ejections_total = 0
        self._reinstatements_total = 0
        self._resumes_total = 0
        self._resumed_tokens_total = 0
        self._journal = ResumeJournal()
        self.retry_budget = RetryBudget(clock=self.clock)
        self._dispatch_pool: Optional[_DispatchPool] = None
        # fleet generations in flight by replica (id), and the lock that
        # makes a pick and its count one step
        self._dispatched: Dict[int, int] = {}
        self._pick_lock = threading.Lock()

    # -- membership ------------------------------------------------------
    def members(self) -> List[SeldonComponent]:
        """Every attached replica, draining ones included."""
        with self._lock:
            return list(self.replicas)

    def draining_members(self) -> List[SeldonComponent]:
        with self._lock:
            return list(self._draining)

    def _dispatchable(self) -> List[SeldonComponent]:
        """The replicas dispatch may target: those neither draining nor
        ejected; else those not ejected; else every replica (touching a
        draining replica, or a dead one, whose submit restarts its loop,
        beats black-holing traffic)."""
        with self._lock:
            live = [r for r in self.replicas
                    if r not in self._draining and r not in self._ejected]
            if live:
                return live
            live = [r for r in self.replicas if r not in self._ejected]
            return live or list(self.replicas)

    def add_replica(self, replica: SeldonComponent) -> None:
        """Attach (and load) one replica; dispatchable at once."""
        if hasattr(replica, "load"):
            replica.load()
        with self._lock:
            self.replicas.append(replica)

    def drain_replica(self, replica: Optional[SeldonComponent] = None
                      ) -> Optional[SeldonComponent]:
        """Start draining ``replica`` (default: the newest serving one, whose
        caches are coldest). Returns it, or None when nothing may drain: the
        last serving replica never does, nor an ejected one (a dead loop
        cannot drain). Its ``drain()`` hook (on it or its batcher service),
        where it has one, is told."""
        with self._lock:
            candidates = [r for r in self.replicas
                          if r not in self._draining and r not in self._ejected]
            if len(candidates) <= 1:
                return None
            if replica is None:
                replica = candidates[-1]
            elif replica not in candidates:
                return None
            self._draining.append(replica)
        hook = self._replica_hook(replica, "drain")
        if hook is not None:
            hook()
        return replica

    def undrain_replica(self) -> Optional[SeldonComponent]:
        """Cancel the newest drain: the warm replica rejoins dispatch.
        Returns it, or None when nothing drains."""
        with self._lock:
            if not self._draining:
                return None
            replica = self._draining.pop()
            self._idle_once.discard(id(replica))
        hook = self._replica_hook(replica, "resume")
        if hook is not None:
            hook()
        return replica

    # -- health: ejection and reinstatement --------------------------------
    def ejected_members(self) -> List[SeldonComponent]:
        with self._lock:
            return list(self._ejected)

    def _breaker_for(self, replica: SeldonComponent) -> CircuitBreaker:
        """The replica's health breaker (made on first use): ejected means
        not CLOSED, and reinstatement is its half-open probe. Its methods
        are never called under ``self._lock`` (each breaker has a lock of
        its own)."""
        rid = id(replica)
        with self._lock:
            br = self._health.get(rid)
            if br is None:
                br = CircuitBreaker(f"replica-{rid:x}", failure_threshold=3,
                                    reset_timeout_s=self.reinstate_after_s, clock=self.clock)
                self._health[rid] = br
        return br

    def _eject(self, replica: SeldonComponent) -> bool:
        with self._lock:
            if replica in self.replicas and replica not in self._ejected:
                self._ejected.append(replica)
                self._ejections_total += 1
                return True
        return False

    def check_health(self) -> List[SeldonComponent]:
        """Eject every replica seen dead: its batcher loop crashed (an
        exception parked in ``batcher.crashed``) or is wedged (its thread
        alive but its heartbeat older than ``heartbeat_timeout_s`` on the
        fleet's clock). Dispatch calls it before each generation and after
        every failure, so a dead replica leaves dispatch within one loop
        turn. Returns the replicas this sweep ejected."""
        with self._lock:
            candidates = [r for r in self.replicas if r not in self._ejected]
        dead = []
        for r in candidates:
            svc = getattr(r, "_batcher_service", None)
            if svc is None:
                continue
            b = svc.batcher
            if getattr(b, "crashed", None) is not None:
                dead.append(r)
                continue
            thread = getattr(b, "_thread", None)
            hb = getattr(b, "heartbeat", None)
            if (thread is not None and thread.is_alive() and hb is not None
                    and self.heartbeat_timeout_s > 0
                    and self.clock() - hb > self.heartbeat_timeout_s):
                dead.append(r)
        out = []
        for r in dead:
            self._breaker_for(r).trip()  # seen dead: open at once
            if self._eject(r):
                logger.warning("ejecting a dead replica from fleet dispatch")
                out.append(r)
        return out

    def _record_dispatch_success(self, replica: SeldonComponent) -> None:
        """A dispatch answered: close the replica's breaker and, if it was
        a probe of an ejected replica, reinstate it."""
        self._breaker_for(replica).record_success()
        with self._lock:
            if replica in self._ejected:
                self._ejected.remove(replica)
                self._reinstatements_total += 1

    def _record_dispatch_failure(self, replica: SeldonComponent) -> None:
        """An infrastructure failure of a dispatch: counted on the breaker
        (consecutive failures open it, a failed probe opens it again), and
        the replica ejected once the breaker is not CLOSED."""
        br = self._breaker_for(replica)
        br.record_failure()
        if br.state_code() != 0:
            self._eject(replica)

    @staticmethod
    def _recoverable(exc: BaseException) -> bool:
        """Which dispatch failures a sibling may retry: infrastructure
        deaths only. Backpressure (ShedError, BreakerOpen) passes through (a
        retry adds to the load that caused it); client errors, cancellations
        and timeouts (the original may still run: a retry could deliver
        twice) are the caller's."""
        if isinstance(exc, (ShedError, BreakerOpen)):
            return False
        if isinstance(exc, (asyncio.CancelledError, concurrent.futures.CancelledError,
                            TimeoutError)):
            return False
        if isinstance(exc, SeldonError):
            return exc.status_code >= 500
        if isinstance(exc, (ValueError, TypeError, KeyError)):
            return False
        return True

    @staticmethod
    def _replica_hook(replica: SeldonComponent, name: str):
        """``name`` on the replica, else on its batcher service."""
        hook = getattr(replica, name, None)
        if hook is not None:
            return hook
        svc = getattr(replica, "_batcher_service", None)
        return getattr(svc, name, None) if svc is not None else None

    def collect_drained(self) -> List[SeldonComponent]:
        """Detach every draining replica seen idle (its ``is_idle()``, else
        a zero ``replica_load``) on two sweeps in a row, re-checked after
        removal (reattached if a submit landed), and close its batcher
        service. A replica still holding work stays and serves it. A sweep
        that overlaps another returns []."""
        if not self._collect_guard.acquire(blocking=False):
            return []
        try:
            return self._collect_locked()
        finally:
            self._collect_guard.release()

    def _collect_locked(self) -> List[SeldonComponent]:
        done = []
        for r in self.draining_members():
            idle_fn = self._replica_hook(r, "is_idle")

            def idle() -> bool:
                return idle_fn() if idle_fn is not None else replica_load(r) == (0.0, 0.0)

            if not idle():
                with self._lock:
                    self._idle_once.discard(id(r))
                continue
            with self._lock:
                first_sighting = id(r) not in self._idle_once
                self._idle_once.add(id(r))
            if first_sighting:
                continue
            with self._lock:
                if r in self.replicas:
                    self.replicas.remove(r)
                if r in self._draining:
                    self._draining.remove(r)
            if not idle():
                # a submit landed between the check and the removal
                with self._lock:
                    self.replicas.append(r)
                    self._draining.append(r)
                    self._idle_once.discard(id(r))
                continue
            with self._lock:
                self._idle_once.discard(id(r))
            svc = getattr(r, "_batcher_service", None)
            if svc is not None:
                # a replica added back builds a new service on first use
                r._batcher_service = None
                try:
                    svc.close()
                except Exception:  # detaching must not fail the sweep
                    logger.exception("closing a drained replica's batcher")
            done.append(r)
        return done

    def load(self) -> None:
        for r in self.members():
            if hasattr(r, "load"):
                r.load()

    # -- dispatch ----------------------------------------------------------
    def _load(self, replica: SeldonComponent) -> Tuple[float, float]:
        """``replica_load``, its queued work counting the fleet generations
        dispatched to the replica and not yet answered too: a generation
        runs on a dispatch thread, so concurrent picks would otherwise all
        read the same idle replica before any of them reaches its queue."""
        queued, pages = replica_load(replica)
        with self._lock:
            return (queued + self._dispatched.get(id(replica), 0), pages)

    def pick(self) -> SeldonComponent:
        """The least-loaded dispatchable replica now (lowest index on ties)."""
        reps = self._dispatchable()
        return min(enumerate(reps), key=lambda ir: (self._load(ir[1]), ir[0]))[1]

    def _probe(self, prompt: Any, reps: List[SeldonComponent]) -> List[Tuple[int, Tuple]]:
        """Each replica's (cached-prefix length of ``prompt``, load)."""
        out = []
        for r in reps:
            probe = getattr(r, "prefix_match_len", None)
            match = int(probe(prompt)) if probe is not None and prompt is not None else 0
            out.append((match, self._load(r)))
        return out

    def pick_for(self, prompt: Any) -> SeldonComponent:
        """Prefix-aware dispatch: the replica whose radix cache holds the
        longest cached prefix of ``prompt`` (a hit there costs block-table
        entries where another replica recomputes the prefill), then the
        least loaded, then the lowest index. ``prefix_match_len`` is a
        host-side probe under the replica's own locks."""
        reps = self._dispatchable()
        probes = self._probe(self._encode_once(prompt, reps), reps)
        best = min(range(len(reps)), key=lambda i: (-probes[i][0], probes[i][1], i))
        return reps[best]

    def _encode_once(self, prompt: Any, reps: Optional[List[SeldonComponent]] = None):
        """A text prompt's ids, tokenized once before the probes fan out
        (replicas share the tokenizer by construction); any other prompt as
        it is."""
        if not isinstance(prompt, str):
            return prompt
        for r in (reps if reps is not None else self.members()):
            tok = getattr(r, "_tokenizer", None)
            if tok is not None:
                return tok.encode(prompt)
        return prompt

    def loads(self) -> List[Tuple[float, float]]:
        return [replica_load(r) for r in self.members()]

    def prefix_match_len(self, prompt: Any) -> int:
        """The longest cached prefix any replica holds (a fleet nests, or a
        router reads its coverage, as one number)."""
        reps = self.members()
        prompt = self._encode_once(prompt, reps)
        return max((m for m, _ in self._probe(prompt, reps)), default=0)

    # -- the batcher-service surface the transports call -----------------
    @property
    def batcher(self):
        """Transports call ``svc.batcher.accommodates``: the fleet answers."""
        return self

    def accommodates(self, prompt: Any, max_new_tokens: Optional[int] = None) -> bool:
        """One dispatchable replica's answer (replicas are identical)."""
        from seldon_core_tpu_torch.runtime.batcher import ensure_stream_service

        for r in self._dispatchable():
            if hasattr(r, "generate"):
                return ensure_stream_service(r).batcher.accommodates(prompt, max_new_tokens)
        return False

    def submit(self, prompt: Any, max_new_tokens: Optional[int] = None,
               seed: Optional[int] = None, info: Optional[dict] = None,
               on_token: Optional[Any] = None, tenant: Optional[str] = None,
               slo_class: Optional[str] = None, adapter: Optional[str] = None,
               deadline_s: Optional[float] = None, timeout_s: float = 600.0,
               trace: Optional[Any] = None) -> Future:
        """``BatcherService.submit``'s surface for the fleet: one fleet
        generation (``_fleet_submit_blocking``) on a dispatch thread (a pool
        of 32). Returns the Future of the final token list; ``on_token`` is
        fed from the serving replica's batcher, with a ``ResumeMarker``
        where a generation resumed, and None once at the end. The call runs
        in a copy of the caller's context: a pool thread starts with an
        empty one, and the active span (the hop's ``traceparent``) and
        deadline must ride along. ``trace``: the request's
        ``tracing.TraceContext``, passed to each replica it runs on."""
        with self._lock:
            pool = self._dispatch_pool
            if pool is None:
                pool = _DispatchPool(32, "fleet-dispatch")
                self._dispatch_pool = pool
        return pool.submit(contextvars.copy_context().run, self._fleet_submit_blocking, prompt,
                           max_new_tokens, on_token, info, seed, tenant, slo_class, adapter,
                           deadline_s, timeout_s, trace)

    # the JAX package's name for a submit from a thread that pumps
    # ``on_token``; the port's submit does not block, so it is the same call
    submit_stream = submit

    def submit_sync(self, prompt: Any, max_new_tokens: Optional[int] = None,
                    timeout_s: float = 600.0, seed: Optional[int] = None,
                    info: Optional[dict] = None, on_token: Optional[Any] = None,
                    **identity: Any) -> List[int]:
        return self.submit(prompt, max_new_tokens, seed=seed, info=info, on_token=on_token,
                           timeout_s=timeout_s, **identity).result()

    def _pick_with_probe(self, prompt: Any) -> Tuple[SeldonComponent, bool]:
        """One attempt's replica: an ejected one whose breaker grants a
        half-open probe (reinstatement rides real traffic; the retry loop
        absorbs a failed probe), else ``pick_for`` over the healthy ones."""
        for r in self.ejected_members():
            if self._breaker_for(r).allow():
                return r, True
        return self.pick_for(prompt), False

    def _fleet_submit_blocking(self, prompt: Any, max_new_tokens: Optional[int] = None,
                               on_token: Optional[Any] = None, info: Optional[dict] = None,
                               seed: Optional[int] = None, tenant: Optional[str] = None,
                               slo_class: Optional[str] = None, adapter: Optional[str] = None,
                               deadline_s: Optional[float] = None,
                               timeout_s: float = 600.0,
                               trace: Optional[Any] = None) -> List[int]:
        """One fleet generation: journal it, dispatch it to the best
        replica and, when that replica dies of an infrastructure failure,
        resume it on a survivor.

        An unseeded request gets a random seed before its first dispatch,
        so greedy and sampled generations alike sit on one chain a resume
        can fast-forward (``ContinuousBatcher._first_key``). Each token is
        journaled before it is forwarded, so a resume skips exactly the
        delivered prefix. The dead batcher's ``on_token(None)`` is swallowed
        (the fleet sends the one None at the end), so a stream survives the
        failover."""
        from seldon_core_tpu_torch.runtime.batcher import ensure_stream_service

        self.check_health()
        self.retry_budget.note_request()
        reps = self._dispatchable()
        ids = self._encode_once(prompt, reps)
        can_resume = not isinstance(ids, str)
        prompt_ids = [int(t) for t in np.asarray(ids).ravel()] if can_resume else ids
        if max_new_tokens is None:
            max_new_tokens = next((int(r.max_new_tokens) for r in reps
                                   if getattr(r, "max_new_tokens", None) is not None), None)
        orig_max_new = int(max_new_tokens or 16)
        if seed is None:
            # pins the chain a resume replays (greedy output ignores it;
            # unseeded sampled output stays random, now resumable)
            seed = secrets.randbits(31)
        jid = self._journal.record(_ResumeEntry(prompt_ids, orig_max_new, seed, tenant,
                                                slo_class, adapter))

        def wrapped(tok):
            if tok is None:
                return  # a dead batcher's end: the fleet sends the real one
            if not isinstance(tok, ResumeMarker):
                self._journal.append(jid, int(tok))
            if on_token is not None:
                on_token(tok)

        try:
            while True:
                done = self._journal.delivered(jid)
                n = len(done)
                if n >= orig_max_new:
                    return done  # the death raced the last token
                submit_ids = prompt_ids + done if n > 0 else prompt_ids
                if n > 0:
                    self._note_resume(n, trace)
                    wrapped(ResumeMarker(n))
                with self._pick_lock:
                    replica, probing = self._pick_with_probe(submit_ids)
                    self._count_dispatch(replica, 1)
                try:
                    toks = ensure_stream_service(replica).submit_sync(
                        submit_ids, orig_max_new - n, timeout_s=timeout_s, info=info, seed=seed,
                        tenant=tenant, slo_class=slo_class, adapter=adapter,
                        deadline_s=deadline_s, on_token=wrapped, resume_tokens=n,
                        **({"trace": trace} if trace is not None else {}))
                except BaseException as e:
                    if probing:
                        self._breaker_for(replica).release_probe()
                    if not self._recoverable(e):
                        raise
                    self._record_dispatch_failure(replica)
                    self.check_health()  # a crash ejects before the retry
                    if self._journal.delivered(jid) and not can_resume:
                        raise  # mid-stream with no token journal: no guess
                    if not self.retry_budget.take():
                        raise ShedError("fleet retry budget exhausted (correlated failures); "
                                        "request not recovered",
                                        retry_after_s=self.reinstate_after_s)
                    continue
                finally:
                    self._count_dispatch(replica, -1)
                self._record_dispatch_success(replica)
                # the replica's result is authoritative for the tail
                # (on_token leaves out EOS; the result does not)
                return done + [int(t) for t in toks]
        finally:
            self._journal.discard(jid)
            if on_token is not None:
                try:
                    on_token(None)
                except Exception:
                    pass

    def _count_dispatch(self, replica: SeldonComponent, n: int) -> None:
        with self._lock:
            left = self._dispatched.get(id(replica), 0) + n
            if left:
                self._dispatched[id(replica)] = left
            else:
                self._dispatched.pop(id(replica), None)

    def _note_resume(self, tokens_delivered: int, trace: Optional[Any] = None) -> None:
        """Count one mid-stream recovery, under an ``llm.resume`` span in
        the resumed request's own trace (its ``trace``): under its caller's
        span when it had one, else a root of that trace. The JAX package
        sends an all-zero parent id there, which its parser refuses, so its
        span lands in a fresh trace."""
        with self._lock:
            self._resumes_total += 1
            self._resumed_tokens_total += tokens_delivered
        tp = None
        if trace is not None:
            flag = "01" if trace.sampled else "00"
            tp = f"00-{trace.trace_id}-{trace.parent_span_id or secrets.token_hex(8)}-{flag}"
        with get_tracer().span("llm.resume", traceparent=tp,
                               tokens_delivered=tokens_delivered) as span:
            if span is not None and trace is not None and trace.parent_span_id is None:
                span.parent_id = None

    # -- the component surface, delegated to the chosen replica ----------
    def predict(self, X, names, meta=None):
        return self.pick().predict(X, names, meta)

    def generate(self, prompts=None, *a, **kw):
        """Routed on the first prompt's cached prefix (a one-prompt request
        is the chat shape prefix routing is for). A recoverable failure
        fails over once, to the least-loaded other replica, from the retry
        budget: nothing was delivered, so the whole call is retried."""
        self.retry_budget.note_request()
        replica = (self.pick_for(prompts[0]) if prompts is not None and len(prompts) > 0
                   else self.pick())
        try:
            out = replica.generate(prompts, *a, **kw)
        except Exception as e:
            if not self._recoverable(e):
                raise
            self._record_dispatch_failure(replica)
            self.check_health()
            siblings = [r for r in self._dispatchable() if r is not replica]
            if not siblings:
                raise
            if not self.retry_budget.try_spend():
                raise ShedError("fleet retry budget exhausted (correlated failures); generate "
                                "not failed over", retry_after_s=self.reinstate_after_s)
            alt = min(siblings, key=replica_load)
            out = alt.generate(prompts, *a, **kw)
            self._record_dispatch_success(alt)
            return out
        self._record_dispatch_success(replica)
        return out

    def tags(self) -> Dict[str, Any]:
        from seldon_core_tpu_torch.components.component import client_custom_tags

        reps = self.members()
        out: Dict[str, Any] = {"replicas": len(reps)}
        for i, r in enumerate(reps):
            for k, v in client_custom_tags(r).items():
                out[f"replica_{i}_{k}"] = v
        return out

    def llm_stats(self) -> Dict[str, Any]:
        """The replicas' stats merged for the scrape: numbers sum (each
        replica's counters and gauges), fractions average, drained lists
        concatenate (each replica's deques drain once, as solo), other
        values come from the first replica. The fleet's own ``fleet_*``
        tallies are stamped after the merge, so no replica key shadows
        them."""
        stats_list = [r.llm_stats() for r in self.members() if hasattr(r, "llm_stats")]
        if not stats_list:
            return {}
        fractions = ("kv_occupancy", "kv_page_fragmentation", "spec_accept_rate",
                     "spec_tokens_per_forward", "spec_draft_overhead_fraction")
        merged = dict(stats_list[0])
        for stats in stats_list[1:]:
            for k, v in stats.items():
                cur = merged.get(k)
                if isinstance(v, list) and isinstance(cur, list):
                    merged[k] = cur + v
                elif (isinstance(v, (int, float)) and isinstance(cur, (int, float))
                      and not isinstance(v, bool)):
                    merged[k] = cur + v
        for k in fractions:  # a sum of fractions would pass 1
            if isinstance(merged.get(k), (int, float)):
                merged[k] = merged[k] / len(stats_list)
        with self._lock:
            merged["fleet_ejections_total"] = self._ejections_total
            merged["fleet_reinstatements_total"] = self._reinstatements_total
            merged["fleet_resumes_total"] = self._resumes_total
            merged["fleet_resumed_tokens_total"] = self._resumed_tokens_total
        merged["fleet_resume_journal_depth"] = self._journal.depth()
        merged["fleet_retry_budget_exhausted_total"] = \
            self.retry_budget.snapshot()["exhausted_total"]
        return merged


@dataclass
class UnitState:
    """Built state of one graph node: its component and children, made
    once at engine build (`engine/.../PredictiveUnitState.java:37-125`)."""

    name: str
    unit: PredictiveUnit
    component: Optional[SeldonComponent]
    children: List["UnitState"] = field(default_factory=list)
    image: str = ""
    # built only for asynchronous nodes: a local call cannot fail apart
    # from this process
    breaker: Optional[CircuitBreaker] = None
    # set when this node's whole subtree runs as one composed function:
    # it takes the request's host array and returns a device tensor
    fused_fn: Optional[Callable[[np.ndarray], torch.Tensor]] = None
    # every unit fused_fn covers, and the component whose class_names and
    # encoding rules own the response (the last node of the unfused flow)
    fused_units: List["UnitState"] = field(default_factory=list)
    fused_owner: Optional[SeldonComponent] = None

    @property
    def methods(self) -> List[UnitMethod]:
        return self.unit.resolved_methods()

    def has_method(self, m: UnitMethod) -> bool:
        return m in self.methods


class PredictorState:
    """The built graph of one predictor."""

    def __init__(self, spec: PredictorSpec, root: UnitState):
        self.spec = spec
        self.root = root

    def walk(self):
        stack = [self.root]
        while stack:
            s = stack.pop()
            yield s
            stack.extend(s.children)

    def unit_by_name(self, name: str) -> Optional[UnitState]:
        for s in self.walk():
            if s.name == name:
                return s
        return None


class GraphEngine:
    """Builds and runs a predictor graph on ``device`` (default "cuda":
    raises without a card; "cpu" only when asked).

    components: name -> a live component for a user node.
    A ``JAX_SERVER`` unit with a ``modelUri`` becomes a ``TorchServer`` on
    the engine's device.
    """

    def __init__(self, spec: PredictorSpec, components: Optional[Dict[str, SeldonComponent]] = None,
                 fuse: bool = True,
                 annotations: Optional[Dict[str, str]] = None,
                 resilience: Optional[ResilienceConfig] = None, device: Optional[str] = None):
        self.spec = spec
        self.device = resolve_device(device)
        self._components = dict(components or {})
        self._fuse = fuse
        self._annotations = dict(annotations or {})
        self.resilience = resilience or ResilienceConfig.from_annotations(self._annotations)
        self._fused_calls = 0
        self._fused_lock = threading.Lock()
        self.state = self._build(spec)
        if fuse:
            self._try_fuse(self.state.root)
        # a graph of local synchronous nodes never truly suspends: its
        # coroutines run to their end without an event loop
        self.has_async_nodes = any(_is_async_component(s.component) for s in self.state.walk())
        for s in self.state.walk():
            if _is_async_component(s.component):
                s.breaker = self.resilience.make_breaker(s.name)

    def breakers(self) -> List[Tuple[str, CircuitBreaker]]:
        """(node name, breaker) of every breaker-wrapped node, sorted."""
        out = [(s.name, s.breaker) for s in self.state.walk() if s.breaker is not None]
        return sorted(out, key=lambda kv: kv[0])

    # ------------------------------------------------------------------
    # Build
    # ------------------------------------------------------------------
    def _build(self, spec: PredictorSpec) -> PredictorState:
        return PredictorState(spec, self._build_unit(spec.graph))

    def _build_unit(self, unit: PredictiveUnit) -> UnitState:
        component = self._resolve(unit)
        return UnitState(name=unit.name, unit=unit, component=component,
                         children=[self._build_unit(c) for c in unit.children],
                         image=type(component).__name__ if component is not None else "")

    def _resolve(self, unit: PredictiveUnit) -> Optional[SeldonComponent]:
        if unit.name in self._components:
            comp = self._components[unit.name]
            if isinstance(comp, (list, tuple)):
                # N replicas behind one dispatcher; cached, so a rebuild and
                # the scrape walking _components see one ReplicaSet
                comp = ReplicaSet(list(comp))
                self._components[unit.name] = comp
        elif unit.implementation is not None and \
                unit.implementation != UnitImplementation.UNKNOWN_IMPLEMENTATION:
            comp = self._make_implementation(unit)
        elif unit.endpoint is not None and unit.endpoint.service_host:
            from seldon_core_tpu_torch.runtime.remote import RemoteComponent

            comp = RemoteComponent(unit.endpoint, annotations=self._annotations or None)
        else:
            raise SeldonError(f"Cannot resolve component for unit {unit.name!r}: no registered "
                              f"component, implementation, or endpoint", reason="BAD_GRAPH",
                              status_code=500)
        if comp is not None and hasattr(comp, "load"):
            comp.load()
        return comp

    def _make_implementation(self, unit: PredictiveUnit) -> SeldonComponent:
        params = unit.parameters_dict()
        try:
            return make_builtin(unit.implementation, params, device=self.device)
        except ValueError:
            pass
        from seldon_core_tpu_torch.servers import make_prepackaged_server

        return make_prepackaged_server(unit.implementation, unit.model_uri, params,
                                       device=str(self.device))

    # ------------------------------------------------------------------
    # Whole-subtree fusion
    # ------------------------------------------------------------------
    def _try_fuse(self, state: UnitState):
        """Bottom-up: when this node and every child are ``torch_fn``
        units and no routing decision is needed, compose the subtree into
        one function. Returns (fn, covered units, owner) or None; only a
        subtree of two or more units gets a ``fused_fn`` (a lone leaf runs
        its own path), but its triple flows up so a parent can fuse it."""
        child_results = [self._try_fuse(c) for c in state.children]
        if (state.component is None or state.has_method(UnitMethod.ROUTE)
                or any(r is None for r in child_results)):
            return None
        hook = getattr(state.component, "torch_fn", None)
        pair = hook() if hook is not None else None
        if pair is None:
            return None
        comp_dev = getattr(state.component, "device", None)
        if comp_dev is not None and torch.device(comp_dev) != self.device:
            raise ValueError(f"unit {state.name!r}: component on {comp_dev}, engine on "
                             f"{self.device}")
        fn, params = pair
        is_combiner = state.has_method(UnitMethod.AGGREGATE)
        if is_combiner and not state.children:
            # a leaf combiner aggregates the singleton [request] on the host
            # path; fn(x) would reduce over the batch dim instead
            return None
        if state.children and not is_combiner and len(state.children) > 1:
            return None  # several children need a combiner to merge them

        if not state.children:
            covered, owner = [state], state.component

            def subtree(x, _fn=fn, _p=params):
                return _fn(_p, x)
        elif is_combiner:
            children = [r[0] for r in child_results]
            covered = [state] + [u for r in child_results for u in r[1]]
            owner = state.component  # the combiner builds the merged response

            def subtree(x, _fn=fn, _p=params, _children=children):
                return _fn(_p, torch.stack([c(x) for c in _children]))
        else:
            # a transformer or model with one child: the child consumes
            # this node's output and owns the response
            child, child_units, owner = child_results[0]
            covered = [state] + child_units

            def subtree(x, _fn=fn, _p=params, _child=child):
                return _child(_fn(_p, x))

        if len(covered) >= 2:
            device = self.device

            def fused(arr: np.ndarray, _subtree=subtree) -> torch.Tensor:
                x, _ = stage_to_device(arr, device, dtype=np.float32)
                with torch.inference_mode():
                    return _subtree(x)

            state.fused_fn = fused
            state.fused_units = covered
            state.fused_owner = owner
            logger.info("fused %d-unit subtree at %s into one function on %s", len(covered),
                        state.name, device)
        return subtree, covered, owner

    # ------------------------------------------------------------------
    # Predict
    # ------------------------------------------------------------------
    async def predict(self, request: SeldonMessage,
                      deadline: Optional[Deadline] = None) -> SeldonMessage:
        if not request.meta.puid:
            request.meta.puid = make_puid()
        puid = request.meta.puid
        # an explicit deadline, else the transport's, else the deployment's
        # default annotation
        if deadline is None:
            deadline = current_deadline()
        if deadline is None and self.resilience.default_deadline_ms:
            deadline = Deadline.from_ms(self.resilience.default_deadline_ms,
                                        clock=self.resilience.clock)
        with deadline_scope(deadline):
            response = await self._get_output(self.state.root, request)
        response.meta.puid = puid
        return response

    def predict_sync(self, request: SeldonMessage) -> SeldonMessage:
        if self.has_async_nodes:
            return asyncio.run(self.predict(request))
        try:
            return _drive_sync(self.predict(request))
        except _Suspended:
            self._degrade_to_async("predict")
            return asyncio.run(self.predict(request))

    def send_feedback_sync(self, feedback: Feedback) -> SeldonMessage:
        if self.has_async_nodes:
            return asyncio.run(self.send_feedback(feedback))
        try:
            return _drive_sync(self.send_feedback(feedback))
        except _Suspended:
            self._degrade_to_async("send_feedback")
            return asyncio.run(self.send_feedback(feedback))

    def _degrade_to_async(self, op: str) -> None:
        """A missed async component: switch the graph to the event-loop
        path for good. The aborted inline attempt already ran every node
        upstream of the suspension, and the retry runs them again: for this
        one request their side effects fire twice."""
        logger.warning("graph suspended on real async work during sync %s despite "
                       "has_async_nodes=False; degrading to the event-loop path. Nodes upstream "
                       "of the suspension re-execute for this request (side effects may fire "
                       "twice, once).", op)
        self.has_async_nodes = True

    def _run_fused(self, state: UnitState, message: SeldonMessage) -> SeldonMessage:
        """The fused subtree: one composed call, and the unfused flow's
        meta (every covered unit's requestPath entry, tags and metrics; the
        flow-final component owns the payload)."""
        out = state.fused_fn(message.data.to_numpy())
        with self._fused_lock:
            self._fused_calls += 1
        resp = dispatch.construct_response(state.fused_owner, False, message, out)
        self._merge_meta(resp, message.meta)
        for unit in state.fused_units:
            if unit.component is not state.fused_owner:
                self._merge_meta(resp, response_meta(unit.component, None))
            self._record_path(resp, unit)
        return resp

    async def _get_output(self, state: UnitState, message: SeldonMessage) -> SeldonMessage:
        # an exhausted budget stops the subtree before any of its work
        deadline = current_deadline()
        if deadline is not None:
            deadline.check(f"node {state.name}")

        if state.fused_fn is not None and message.which == "data" and message.data is not None:
            return self._run_fused(state, message)

        # 1. transformInput (a MODEL's is predict, `PredictorConfigBean.java:30-107`)
        if state.has_method(UnitMethod.TRANSFORM_INPUT):
            fn = dispatch.predict if state.unit.type == UnitType.MODEL else dispatch.transform_input
            transformed = await self._call(fn, state, message)
            self._merge_meta(transformed, message.meta)
        else:
            transformed = message

        # 2. route
        branch = -1
        if state.has_method(UnitMethod.ROUTE) and state.children:
            route_msg = await self._call(dispatch.route, state, transformed)
            branch = dispatch.extract_route(route_msg)
            if branch >= len(state.children):
                raise SeldonError(f"Router {state.name} returned branch {branch} but unit has "
                                  f"{len(state.children)} children", status_code=500,
                                  reason="BAD_ROUTING")
            if branch >= 0:
                # reroute away from a branch whose subtree has an open breaker
                healthy = self._healthy_branch(state, branch)
                if healthy != branch:
                    logger.warning("router %s: branch %d unavailable (breaker open), rerouting "
                                   "to %d", state.name, branch, healthy)
                    rerouted = dict(transformed.meta.tags.get(TAG_REROUTED) or {})
                    rerouted[state.name] = {"from": branch, "to": healthy}
                    transformed.meta.tags[TAG_REROUTED] = rerouted
                    branch = healthy
            transformed.meta.routing[state.name] = branch
            self._merge_meta(transformed, route_msg.meta, routing_only_tags=True)

        # 3. children
        dropped_branches: List[str] = []
        if state.children and branch == -1:
            allow_partial = (self.resilience.allow_partial
                             and state.has_method(UnitMethod.AGGREGATE)
                             and len(state.children) > 1)
            if self.has_async_nodes:
                results = await asyncio.gather(
                    *[self._get_output(c, transformed) for c in state.children],
                    return_exceptions=allow_partial)
            else:
                # local components are synchronous: gather buys nothing and
                # would need an event loop
                results = []
                for c in state.children:
                    try:
                        results.append(await self._get_output(c, transformed))
                    except SeldonError as e:
                        if not allow_partial:
                            raise
                        results.append(e)
            child_outputs = []
            for child, r in zip(state.children, results):
                if isinstance(r, BaseException):
                    # partial responses drop only branches an open breaker
                    # rejected; a failing node still fails the request
                    if isinstance(r, BreakerOpen):
                        dropped_branches.append(child.name)
                        continue
                    raise r
                child_outputs.append(r)
            if not child_outputs and dropped_branches:
                raise SeldonError(f"combiner {state.name}: every branch dropped by open circuit "
                                  f"breakers ({', '.join(dropped_branches)})", status_code=503,
                                  reason="CIRCUIT_OPEN")
        elif state.children:
            child_outputs = [await self._routed_output(state, branch, transformed)]
        else:
            child_outputs = []

        # 4. aggregate / merge
        if state.has_method(UnitMethod.AGGREGATE):
            if not child_outputs:
                child_outputs = [transformed]
            merged = await self._call(dispatch.aggregate, state,
                                      SeldonMessageList(messages=list(child_outputs)))
            for co in child_outputs:
                self._merge_meta(merged, co.meta)
            if dropped_branches:
                merged.meta.tags[TAG_PARTIAL_RESPONSE] = True
                merged.meta.tags[TAG_DROPPED_BRANCHES] = list(dropped_branches)
        elif len(child_outputs) == 1:
            merged = child_outputs[0]
        elif len(child_outputs) > 1:
            raise SeldonError(f"Unit {state.name} has {len(child_outputs)} child outputs but no "
                              f"COMBINER to aggregate them", status_code=500, reason="BAD_GRAPH")
        else:
            merged = transformed

        # 5. transformOutput
        if state.has_method(UnitMethod.TRANSFORM_OUTPUT):
            out = await self._call(dispatch.transform_output, state, merged)
            self._merge_meta(out, merged.meta)
        else:
            out = merged

        self._record_path(out, state)
        return out

    async def _routed_output(self, state: UnitState, branch: int,
                             message: SeldonMessage) -> SeldonMessage:
        """The routed child's output. A router with an
        ``observe_outcome(branch, latency_s, error)`` hook sees each routed
        request's subtree wall and error on the engine's clock."""
        child = state.children[branch]
        observe = getattr(state.component, "observe_outcome", None)
        if observe is None:
            return await self._get_output(child, message)
        t0 = self.resilience.clock()
        try:
            out = await self._get_output(child, message)
        except asyncio.CancelledError:
            raise  # a client disconnect says nothing about the branch
        except BaseException:
            self._observe_routed(observe, branch, self.resilience.clock() - t0, True)
            raise
        self._observe_routed(observe, branch, self.resilience.clock() - t0, False)
        return out

    @staticmethod
    def _observe_routed(observe, branch: int, latency_s: float, error: bool) -> None:
        try:
            observe(branch, latency_s, error=error)
        except Exception:  # observability must never fail the data path
            logger.exception("router observe_outcome hook failed")

    @staticmethod
    def _subtree_available(state: UnitState) -> bool:
        """Is every breaker of this subtree accepting calls (no probe slot
        consumed)?"""
        stack = [state]
        while stack:
            s = stack.pop()
            if s.breaker is not None and not s.breaker.available():
                return False
            stack.extend(s.children)
        return True

    def _healthy_branch(self, state: UnitState, branch: int) -> int:
        """The routed branch if its subtree is healthy, else the lowest
        healthy sibling; all unhealthy keeps the routed branch."""
        if self._subtree_available(state.children[branch]):
            return branch
        for i, child in enumerate(state.children):
            if i != branch and self._subtree_available(child):
                return i
        return branch

    async def _call(self, fn: Callable, state: UnitState, message: Any) -> SeldonMessage:
        comp = state.component
        if comp is None:
            raise SeldonError(f"Unit {state.name} has no component", status_code=500)
        breaker = state.breaker
        if breaker is not None and not breaker.allow():
            raise BreakerOpen(state.name, breaker.retry_in_s())
        with get_tracer().span(f"node:{state.name}", method=getattr(fn, "__name__", "")):
            try:
                result = fn(comp, message)
                if inspect.isawaitable(result):
                    result = await result
            except BaseException as e:
                # every outcome resolves a half-open probe
                if breaker is not None:
                    if failure_counts_for_breaker(e):
                        breaker.record_failure()
                    elif isinstance(e, asyncio.CancelledError):
                        breaker.release_probe()
                    else:
                        breaker.record_success()
                raise
        if breaker is not None:
            breaker.record_success()
        return result

    @staticmethod
    def _merge_meta(target: SeldonMessage, source: Meta, routing_only_tags: bool = False) -> None:
        """The reference's mergeMeta (`PredictiveUnitBean.java:350-366`):
        tags union (the response wins), routing and requestPath union,
        metrics appended."""
        merged_tags = dict(source.tags)
        merged_tags.update(target.meta.tags)
        target.meta.tags = merged_tags
        for k, v in source.routing.items():
            target.meta.routing.setdefault(k, v)
        for k, v in source.request_path.items():
            target.meta.request_path.setdefault(k, v)
        if not routing_only_tags:
            existing = {id(m) for m in target.meta.metrics}
            for m in source.metrics:
                if id(m) not in existing:
                    target.meta.metrics.append(m)
        if source.puid and not target.meta.puid:
            target.meta.puid = source.puid

    @staticmethod
    def _record_path(msg: SeldonMessage, state: UnitState) -> None:
        msg.meta.request_path[state.name] = state.image

    # ------------------------------------------------------------------
    # Feedback
    # ------------------------------------------------------------------
    async def send_feedback(self, feedback: Feedback) -> SeldonMessage:
        return await self._feedback(self.state.root, feedback)

    async def _feedback(self, state: UnitState, feedback: Feedback) -> SeldonMessage:
        if state.has_method(UnitMethod.SEND_FEEDBACK) and state.component is not None:
            result = dispatch.send_feedback(state.component, feedback, unit_id=state.name)
            if inspect.isawaitable(result):
                await result
        # replay down the routed branch only (`PredictiveUnitBean.java:210-218`)
        if state.children:
            routing = feedback.response.meta.routing if feedback.response is not None else {}
            branch = routing.get(state.name, -1)
            if branch == -1:
                if self.has_async_nodes:
                    await asyncio.gather(*[self._feedback(c, feedback) for c in state.children])
                else:
                    for c in state.children:
                        await self._feedback(c, feedback)
            elif 0 <= branch < len(state.children):
                await self._feedback(state.children[branch], feedback)
            else:
                raise SeldonError(f"Feedback routing for {state.name} names branch {branch} "
                                  f"outside {len(state.children)} children", reason="BAD_ROUTING")
        return SeldonMessage()


__all__ = ["GraphEngine", "PredictorState", "ReplicaSet", "UnitState", "make_puid",
           "replica_load"]
