"""Resilience primitives of the port: deadline budgets, circuit breakers,
load shedding. Copied from ``seldon_core_tpu/runtime/resilience.py``, the
parts the graph engine and its transports use:

- **Deadline**: a request-level time budget from the transport edge (REST
  header ``Seldon-Deadline-Ms``, gRPC ``seldon-deadline-ms`` metadata or the
  call's deadline) through the engine's node execution; an exhausted budget
  stops the remaining nodes with 504 / ``DEADLINE_EXCEEDED``. It travels
  in a contextvar, so the sync engine path (``GraphEngine.predict_sync`` on
  a transport thread) reads it without signature changes.
- **CircuitBreaker**: per node, closed -> open (after N consecutive
  failures) -> half-open probe -> closed. The engine wraps asynchronous
  node calls in one; a ROUTER reroutes around an open child and a COMBINER
  drops open branches when the graph allows partial responses.
- **AdmissionController**: bounded in-flight plus a bounded FIFO queue at
  the transport edge; overflow sheds at once (503 + ``Retry-After`` /
  ``RESOURCE_EXHAUSTED``). The port's transports run each request on a
  thread of their own (the stdlib HTTP server, gRPC's pool), so admission
  here is the JAX package's thread-blocking half (``acquire_sync``).
- **ShedError**: the shed itself; the batcher raises it too when the KV
  page pool is exhausted.

- **RetryBudget**, **ResumeJournal**, **ResumeMarker**: the replica
  fleet's recovery (``runtime/engine.ReplicaSet``): a bounded budget of
  re-dispatches, the token-granular journal of every fleet generation in
  flight, and the in-band stream event of a resume.

Everything takes an injectable monotonic ``clock`` for deterministic
tests. ``effective_timeout`` clamps a remote hop to the budget left.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Callable, Dict, List, Optional

from seldon_core_tpu_torch.contracts.payload import SeldonError

ANNOTATION_DEADLINE_DEFAULT = "seldon.io/deadline-default-ms"
ANNOTATION_BREAKER_FAILURES = "seldon.io/circuit-breaker-max-failures"
ANNOTATION_BREAKER_RESET = "seldon.io/circuit-breaker-reset-ms"
ANNOTATION_ALLOW_PARTIAL = "seldon.io/allow-partial"
ANNOTATION_MAX_INFLIGHT = "seldon.io/max-inflight"
ANNOTATION_MAX_QUEUE = "seldon.io/max-queue"
ANNOTATION_RETRY_AFTER = "seldon.io/shed-retry-after-s"

DEADLINE_HEADER = "Seldon-Deadline-Ms"
DEADLINE_GRPC_METADATA = "seldon-deadline-ms"

DEFAULT_BREAKER_FAILURES = 5
DEFAULT_BREAKER_RESET_S = 30.0
DEFAULT_RETRY_AFTER_S = 1


def _parse_float(annotations: Dict[str, str], key: str,
                 default: Optional[float]) -> Optional[float]:
    try:
        return float(annotations[key])
    except (KeyError, TypeError, ValueError):
        return default


def _parse_int(annotations: Dict[str, str], key: str, default: int) -> int:
    try:
        return int(annotations[key])
    except (KeyError, TypeError, ValueError):
        return default


# ---------------------------------------------------------------------------
# Deadline budgets
# ---------------------------------------------------------------------------


class DeadlineExceeded(SeldonError):
    """Request budget exhausted: HTTP 504 / gRPC DEADLINE_EXCEEDED."""

    def __init__(self, message: str):
        super().__init__(message, status_code=504, reason="DEADLINE_EXCEEDED")


class Deadline:
    """A monotonic-clock time budget for one request. ``clock`` is any
    zero-argument callable returning monotonic seconds."""

    __slots__ = ("budget_s", "clock", "deadline_t")

    def __init__(self, budget_s: float, clock: Callable[[], float] = time.monotonic):
        self.budget_s = float(budget_s)
        self.clock = clock
        self.deadline_t = clock() + self.budget_s

    @classmethod
    def from_ms(cls, ms: float, clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(float(ms) / 1000.0, clock=clock)

    def remaining_s(self) -> float:
        return self.deadline_t - self.clock()

    def check(self, where: str = "") -> None:
        rem = self.remaining_s()
        if rem <= 0.0:
            at = f" at {where}" if where else ""
            raise DeadlineExceeded(
                f"deadline exceeded{at}: budget {self.budget_s * 1000:.0f}ms "
                f"overrun by {-rem * 1000:.0f}ms")


# The in-flight request's deadline, set by a transport (or engine.predict
# given one) and read by the engine before each node.
DEADLINE: ContextVar[Optional[Deadline]] = ContextVar("seldon_deadline", default=None)


def current_deadline() -> Optional[Deadline]:
    return DEADLINE.get()


@contextmanager
def deadline_scope(deadline: Optional[Deadline]):
    token = DEADLINE.set(deadline)
    try:
        yield deadline
    finally:
        DEADLINE.reset(token)


def effective_timeout(per_hop_s: Optional[float],
                      deadline: Optional[Deadline] = None) -> Optional[float]:
    """``min(per-hop timeout, remaining budget)`` for one remote hop. Raises
    DeadlineExceeded when the budget is already spent: a caller never starts
    network work it cannot finish in time."""
    if deadline is None:
        deadline = current_deadline()
    if deadline is None:
        return per_hop_s
    rem = deadline.remaining_s()
    if rem <= 0.0:
        raise DeadlineExceeded(f"deadline exceeded before remote hop: budget "
                               f"{deadline.budget_s * 1000:.0f}ms already spent")
    return rem if per_hop_s is None else min(per_hop_s, rem)


# ---------------------------------------------------------------------------
# Circuit breakers
# ---------------------------------------------------------------------------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class BreakerOpen(SeldonError):
    """Call rejected because the node's breaker is open."""

    def __init__(self, node: str, retry_in_s: float):
        super().__init__(
            f"circuit breaker open for node {node!r} (retry in {max(retry_in_s, 0.0):.1f}s)",
            status_code=503, reason="CIRCUIT_OPEN")
        self.node = node
        self.retry_in_s = max(retry_in_s, 0.0)


class CircuitBreaker:
    """Per-node breaker: closed -> open after ``failure_threshold``
    consecutive failures -> half-open probe after ``reset_timeout_s`` ->
    closed on the probe's success (open again on its failure). Thread-safe;
    ``clock`` may be swapped after build."""

    def __init__(self, name: str, failure_threshold: int = DEFAULT_BREAKER_FAILURES,
                 reset_timeout_s: float = DEFAULT_BREAKER_RESET_S,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.clock = clock
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at = 0.0
        self._probe_inflight = False
        self.transitions: Dict[str, int] = {CLOSED: 0, OPEN: 0, HALF_OPEN: 0}
        self.rejected_total = 0
        self.on_transition: Optional[Callable[[str, str], None]] = None
        self._lock = threading.Lock()

    def _transition(self, to: str) -> None:
        self.state = to
        self.transitions[to] += 1
        if to == OPEN:
            self.opened_at = self.clock()
            self.consecutive_failures = 0
        if to != HALF_OPEN:
            self._probe_inflight = False
        cb = self.on_transition
        if cb is not None:
            try:
                cb(self.name, to)
            except Exception:
                pass  # observability must never fail the data path

    def allow(self) -> bool:
        """May a call proceed now? Consumes the half-open probe slot."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if self.clock() - self.opened_at >= self.reset_timeout_s:
                    self._transition(HALF_OPEN)
                else:
                    self.rejected_total += 1
                    return False
            if self._probe_inflight:  # half-open: one probe at a time
                self.rejected_total += 1
                return False
            self._probe_inflight = True
            return True

    def available(self) -> bool:
        """Would a call be allowed, without consuming the probe slot?"""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                return self.clock() - self.opened_at >= self.reset_timeout_s
            return not self._probe_inflight

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            if self.state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            if self.state == HALF_OPEN:
                self._transition(OPEN)
                return
            self.consecutive_failures += 1
            if self.state == CLOSED and 0 < self.failure_threshold <= self.consecutive_failures:
                self._transition(OPEN)

    def release_probe(self) -> None:
        """The probe's outcome is unknown (cancelled): free the half-open
        slot without judging the node."""
        with self._lock:
            if self.state == HALF_OPEN:
                self._probe_inflight = False

    def trip(self) -> None:
        """Force open, whatever the failure count."""
        with self._lock:
            if self.state != OPEN:
                self._transition(OPEN)

    def retry_in_s(self) -> float:
        with self._lock:
            if self.state != OPEN:
                return 0.0
            return self.reset_timeout_s - (self.clock() - self.opened_at)

    def state_code(self) -> int:
        """0 closed, 1 half-open, 2 open (the metrics gauge's encoding)."""
        with self._lock:
            return _STATE_CODES[self.state]


# ---------------------------------------------------------------------------
# Admission control (load shedding)
# ---------------------------------------------------------------------------


class ShedError(SeldonError):
    """Request shed at admission: server at capacity and queue full."""

    def __init__(self, message: str, retry_after_s: float = DEFAULT_RETRY_AFTER_S):
        super().__init__(message, status_code=503, reason="RESOURCE_EXHAUSTED")
        self.retry_after_s = retry_after_s


class AdmissionController:
    """Bounded in-flight limit plus a bounded FIFO queue, shedding when
    both are full. ``max_inflight <= 0`` disables it (the default).
    Callers on their own thread ``acquire_sync()`` and ``release()``.
    ``retry_after_fn`` (optional, ``wire_retry_after`` sets it) refines each
    shed's Retry-After from the live backlog; it is called outside the
    lock, and one that raises leaves the configured constant."""

    def __init__(self, max_inflight: int = 0, max_queue: int = 0,
                 retry_after_s: float = DEFAULT_RETRY_AFTER_S,
                 retry_after_fn: Optional[Callable[[], float]] = None):
        self.max_inflight = int(max_inflight)
        self.max_queue = int(max_queue)
        self.retry_after_s = float(retry_after_s)
        self.retry_after_fn = retry_after_fn
        self.inflight = 0
        self.shed_total = 0
        self.admitted_total = 0
        self._waiters: deque = deque()  # threading.Event a waiter
        self._lock = threading.Lock()

    @classmethod
    def from_annotations(cls, annotations: Optional[Dict[str, str]],
                         env: Optional[Dict[str, str]] = None) -> "AdmissionController":
        """Annotations win over env vars (SELDON_MAX_INFLIGHT /
        SELDON_MAX_QUEUE / SELDON_SHED_RETRY_AFTER_S); both absent means
        disabled."""
        import os

        env = dict(env if env is not None else os.environ)
        ann = dict(annotations or {})

        def pick(key: str, env_key: str, default: float) -> float:
            for source, k in ((ann, key), (env, env_key)):
                try:
                    return float(source[k])
                except (KeyError, TypeError, ValueError):
                    continue
            return default

        return cls(
            max_inflight=int(pick(ANNOTATION_MAX_INFLIGHT, "SELDON_MAX_INFLIGHT", 0)),
            max_queue=int(pick(ANNOTATION_MAX_QUEUE, "SELDON_MAX_QUEUE", 0)),
            retry_after_s=pick(ANNOTATION_RETRY_AFTER, "SELDON_SHED_RETRY_AFTER_S",
                               DEFAULT_RETRY_AFTER_S))

    @property
    def enabled(self) -> bool:
        return self.max_inflight > 0

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._waiters)

    def _shed(self) -> ShedError:
        """Build and count one shed; callers hold the lock."""
        self.shed_total += 1
        return ShedError(f"server at capacity: {self.inflight} in flight, "
                         f"{len(self._waiters)}/{self.max_queue} queued",
                         retry_after_s=self.retry_after_s)

    def _refine(self, err: ShedError) -> ShedError:
        """The dynamic Retry-After on a shed built under the lock; called
        outside it."""
        fn = self.retry_after_fn
        if fn is not None:
            try:
                err.retry_after_s = float(fn())
            except Exception:  # a backoff hint must never mask the shed itself
                pass
        return err

    def acquire_sync(self, timeout_s: Optional[float] = None) -> None:
        """An immediate slot, else a place in the queue (blocking this
        thread until a release hands it a slot), else ShedError."""
        if not self.enabled:
            return
        with self._lock:
            if self.inflight < self.max_inflight:
                self.inflight += 1
                self.admitted_total += 1
                return
            err = self._shed() if len(self._waiters) >= self.max_queue else None
            if err is None:
                event = threading.Event()
                self._waiters.append(event)
        if err is not None:
            raise self._refine(err)
        if event.wait(timeout_s):
            return
        with self._lock:
            try:
                self._waiters.remove(event)
            except ValueError:  # the grant raced the timeout: give the slot back
                granted = True
            else:
                granted = False
                err = self._shed()
        if not granted:
            raise self._refine(err)
        self.release()
        with self._lock:
            err = self._shed()
        raise self._refine(err)

    def release(self) -> None:
        """Finish one admitted request; hand its slot to the oldest waiter."""
        if not self.enabled:
            return
        with self._lock:
            if self._waiters:
                self._waiters.popleft().set()
                self.admitted_total += 1  # slot transferred, inflight unchanged
                return
            self.inflight = max(self.inflight - 1, 0)


def retry_after_hint(component: Any, default_s: float = DEFAULT_RETRY_AFTER_S) -> float:
    """A component's dynamic Retry-After for sheds: its shared batcher's
    backlog hint (``ContinuousBatcher.retry_after_hint``), never below the
    configured ``default_s``; ``default_s`` for a component without one."""
    svc = getattr(component, "_batcher_service", None)
    hint = getattr(getattr(svc, "batcher", None), "retry_after_hint", None)
    if hint is None:
        return float(default_s)
    return max(float(hint()), float(default_s))


def wire_retry_after(admission: "AdmissionController", component: Any) -> "AdmissionController":
    """Install ``retry_after_hint`` of ``component`` as the admission
    controller's ``retry_after_fn``, unless one is set already."""
    if admission.retry_after_fn is None:
        admission.retry_after_fn = lambda: retry_after_hint(component, admission.retry_after_s)
    return admission


# ---------------------------------------------------------------------------
# Engine-level config
# ---------------------------------------------------------------------------


class ResilienceConfig:
    """Per-graph resilience settings, parsed from deployment annotations."""

    __slots__ = ("breaker_failures", "breaker_reset_s", "allow_partial", "default_deadline_ms",
                 "clock")

    def __init__(self, breaker_failures: int = DEFAULT_BREAKER_FAILURES,
                 breaker_reset_s: float = DEFAULT_BREAKER_RESET_S, allow_partial: bool = False,
                 default_deadline_ms: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.breaker_failures = breaker_failures
        self.breaker_reset_s = breaker_reset_s
        self.allow_partial = allow_partial
        self.default_deadline_ms = default_deadline_ms
        self.clock = clock

    @classmethod
    def from_annotations(cls, annotations: Optional[Dict[str, str]]) -> "ResilienceConfig":
        ann = dict(annotations or {})
        reset_ms = _parse_float(ann, ANNOTATION_BREAKER_RESET, DEFAULT_BREAKER_RESET_S * 1000.0)
        return cls(
            breaker_failures=_parse_int(ann, ANNOTATION_BREAKER_FAILURES,
                                        DEFAULT_BREAKER_FAILURES),
            breaker_reset_s=(reset_ms or 0.0) / 1000.0,
            allow_partial=str(ann.get(ANNOTATION_ALLOW_PARTIAL, "")).lower()
            in ("true", "1", "yes"),
            default_deadline_ms=_parse_float(ann, ANNOTATION_DEADLINE_DEFAULT, None))

    def make_breaker(self, name: str) -> Optional[CircuitBreaker]:
        if self.breaker_failures <= 0:
            return None
        return CircuitBreaker(name, failure_threshold=self.breaker_failures,
                              reset_timeout_s=self.breaker_reset_s, clock=self.clock)


def failure_counts_for_breaker(exc: BaseException) -> bool:
    """Which errors trip a breaker: infrastructure failures (5xx, timeouts,
    transport errors); not client errors (4xx), not the breaker's own
    rejections and not cancellation."""
    if isinstance(exc, (BreakerOpen, asyncio.CancelledError)):
        return False
    if isinstance(exc, SeldonError):
        return exc.status_code >= 500
    return True


# ---------------------------------------------------------------------------
# Fleet fault tolerance: retry budget, resume journal, resume marker
# ---------------------------------------------------------------------------

DEFAULT_RETRY_BUDGET_RATIO = 0.2
DEFAULT_RETRY_BUDGET_MIN = 3
DEFAULT_RETRY_BUDGET_WINDOW_S = 10.0


class RetryBudget:
    """The fleet's bounded recovery budget (copied from the JAX package).
    A resume or a pre-first-token failover re-dispatches work the fleet
    already paid for once, so a correlated failure (half the replicas dying
    at once) could double the offered load just as capacity halves. Every
    recovery draws from this budget: a sliding-window fraction of recent
    requests plus a small fixed floor; a spent budget is an honest shed
    (503 + Retry-After), not amplification.

    Retries granted inside any window never exceed ``ratio *
    requests_in_window + min_retries``. Thread-safe."""

    def __init__(self, ratio: float = DEFAULT_RETRY_BUDGET_RATIO,
                 min_retries: int = DEFAULT_RETRY_BUDGET_MIN,
                 window_s: float = DEFAULT_RETRY_BUDGET_WINDOW_S,
                 clock: Callable[[], float] = time.monotonic):
        self.ratio = float(ratio)
        self.min_retries = int(min_retries)
        self.window_s = float(window_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._requests: deque = deque()  # request timestamps
        self._retries: deque = deque()   # granted-retry timestamps
        self.exhausted_total = 0

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        while self._requests and self._requests[0] < horizon:
            self._requests.popleft()
        while self._retries and self._retries[0] < horizon:
            self._retries.popleft()

    def note_request(self) -> None:
        """One request entered the fleet (grows the budget)."""
        now = self.clock()
        with self._lock:
            self._prune(now)
            self._requests.append(now)

    def try_spend(self) -> bool:
        """Grant one recovery if the window has budget left. False means
        the caller sheds, and the refusal is counted."""
        now = self.clock()
        with self._lock:
            self._prune(now)
            if len(self._retries) < self.ratio * len(self._requests) + self.min_retries:
                self._retries.append(now)
                return True
            self.exhausted_total += 1
            return False

    # the JAX package's second name for it (its leak sweep's acquire site)
    take = try_spend

    def snapshot(self) -> Dict[str, float]:
        """One consistent view for the stats."""
        now = self.clock()
        with self._lock:
            self._prune(now)
            return {"requests_in_window": len(self._requests),
                    "retries_in_window": len(self._retries),
                    "exhausted_total": self.exhausted_total}


class ResumeJournal:
    """The fleet's token-granular recovery journal (copied from the JAX
    package). ``record()`` opens an entry and the dispatch's ``finally``
    must ``discard()`` it on every path. Batcher threads ``append`` while
    the retry loop reads ``delivered()``; every access takes the journal's
    lock, so a snapshot never tears. ``append`` and ``delivered`` on a
    discarded id do nothing: a straggler token from a dead replica's loop
    must not bring the entry back."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[int, Any] = {}
        self._seq = 0

    def record(self, entry: Any) -> int:
        """Open one entry; returns its id (owed a ``discard``)."""
        with self._lock:
            self._seq += 1
            self._entries[self._seq] = entry
            return self._seq

    def append(self, jid: int, token: int) -> None:
        """One delivered token, recorded BEFORE the client sees it, so a
        resume skips exactly the delivered prefix (at most once)."""
        with self._lock:
            entry = self._entries.get(jid)
            if entry is not None:
                entry.tokens.append(int(token))

    def delivered(self, jid: int) -> List[int]:
        """The tokens delivered so far ([] after discard)."""
        with self._lock:
            entry = self._entries.get(jid)
            return list(entry.tokens) if entry is not None else []

    def get(self, jid: int) -> Optional[Any]:
        """The live entry (None after discard), for tests."""
        with self._lock:
            return self._entries.get(jid)

    def discard(self, jid: int) -> None:
        """End the entry (idempotent)."""
        with self._lock:
            self._entries.pop(jid, None)

    def depth(self) -> int:
        """Entries open (``fleet_resume_journal_depth``)."""
        with self._lock:
            return len(self._entries)


class ResumeMarker:
    """In-band stream event, never a token: a recovered generation
    re-attached after ``tokens_delivered`` delivered tokens. It rides
    ``on_token``, so SSE sends one ``resumed`` event and gRPC one
    ``resumed`` chunk where the failover happened."""

    __slots__ = ("tokens_delivered",)

    def __init__(self, tokens_delivered: int):
        self.tokens_delivered = int(tokens_delivered)


__all__ = ["AdmissionController", "BreakerOpen", "CircuitBreaker", "DEADLINE_GRPC_METADATA",
           "DEADLINE_HEADER", "DEFAULT_RETRY_AFTER_S", "DEFAULT_RETRY_BUDGET_RATIO", "Deadline",
           "DeadlineExceeded", "ResilienceConfig", "ResumeJournal", "ResumeMarker",
           "RetryBudget", "ShedError", "current_deadline", "deadline_scope",
           "effective_timeout", "failure_counts_for_breaker", "retry_after_hint",
           "wire_retry_after"]
