"""Request-scoped tracing of the port (copied from
``seldon_core_tpu/tracing``; the port imports nothing of the JAX package).

A small native tracer with the reference's span topology (a server span at
the transport, a child span per graph node) and W3C ``traceparent``
propagation; ``tracing/export.py`` ships finished spans to an OTLP/HTTP
collector. Off unless ``TRACING=1`` (the service name from
``JAEGER_SERVICE_NAME``); off, every ``span()`` yields None at the cost of
one attribute read.

Serving timelines (the batcher's flight recorder, ``runtime/flight.py``)
materialize into the same span model: one tree per request, rooted at the
transport ingress, fed through this tracer's buffer to the exporter.
Sampling is two-stage: the inbound ``traceparent``'s sampled flag is the
head decision, and the recorder still retains an unsampled request whose
TTFT or worst inter-token gap crosses the tail thresholds
(``TRACING_TAIL_TTFT_MS`` / ``TRACING_TAIL_GAP_MS``).

Clock: span timestamps come from :func:`now`, a monotonic clock anchored to
the wall clock once at module import (re-anchor with :func:`anchor`, only
while no span is open), so a wall-clock step never changes a duration.

Context rides a ``contextvars`` variable. A thread started by hand, or a
call run on a pool thread, starts with an empty context: code that hands
work to another thread and wants the hop to stay in the trace runs it
inside ``contextvars.copy_context().run`` (the fleet's dispatch pool does).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "seldon_current_span", default=None)

# ---------------------------------------------------------------------------
# Anchored monotonic clock
# ---------------------------------------------------------------------------
_mono = time.monotonic
_wall_anchor = time.time()
_mono_anchor = time.monotonic()


def anchor(wall=time.time, mono=time.monotonic) -> None:
    """(Re-)anchor the span clock: absolute time = the wall clock at the
    anchor plus monotonic time elapsed since. Called once at import; only
    re-anchor while no span is open. Tests pass fake ``wall`` / ``mono``
    sources to step the clocks."""
    global _mono, _wall_anchor, _mono_anchor
    _mono = mono
    _wall_anchor = wall()
    _mono_anchor = mono()


def now() -> float:
    """Wall-anchored monotonic seconds: the span timestamp source."""
    return _wall_anchor + (_mono() - _mono_anchor)


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start: float = field(default_factory=now)
    end: Optional[float] = None
    tags: Dict[str, Any] = field(default_factory=dict)
    # the W3C sampled flag: an unsampled span propagates its context but is
    # never buffered (unless the flight recorder's tail sampling retains
    # the whole request tree)
    sampled: bool = True
    # set by Tracer.flush when a failed export re-enqueued this span; a
    # second failure drops it
    requeued: bool = False

    def finish(self) -> None:
        self.end = now()

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "traceId": self.trace_id, "spanId": self.span_id,
                "parentId": self.parent_id, "startUs": int(self.start * 1e6),
                "durationUs": int(((self.end or now()) - self.start) * 1e6), "tags": self.tags}

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{'01' if self.sampled else '00'}"


@dataclass
class TraceContext:
    """A request's trace identity, carried from the transport ingress into
    the batcher: what the flight recorder roots the request's span tree
    at. ``parent_span_id`` is the caller's span when the request came with
    a ``traceparent``; ``sampled`` is the head decision tail sampling may
    override."""

    trace_id: str
    parent_span_id: Optional[str] = None
    sampled: bool = True
    ingress: str = ""

    @classmethod
    def from_traceparent(cls, header: Optional[str], ingress: str = "") -> "TraceContext":
        """The context of an inbound W3C ``traceparent``; an absent or
        malformed header starts a fresh, sampled trace."""
        parsed = _parse_traceparent(header) if header else None
        if parsed is None:
            return cls(trace_id=secrets.token_hex(16), parent_span_id=None, sampled=True,
                       ingress=ingress)
        trace_id, span_id, sampled = parsed
        return cls(trace_id=trace_id, parent_span_id=span_id, sampled=sampled, ingress=ingress)


def current_traceparent() -> Optional[str]:
    """The active span's outbound ``traceparent`` (None outside any span):
    what a remote hop sends so the next service joins this trace."""
    s = _current_span.get()
    return s.traceparent() if s is not None else None


def ingress_trace(tracer: "Tracer", header: Optional[str],
                  ingress: str) -> Optional[TraceContext]:
    """The transports' one trace set-up (REST ``/v1/generate`` and gRPC
    ``GenerateStream``): None when tracing is off, else the inbound
    header's context rooted at ``ingress``."""
    if not tracer.enabled:
        return None
    return TraceContext.from_traceparent(header, ingress=ingress)


def current_trace_context(ingress: str = "") -> Optional[TraceContext]:
    """A TraceContext under the ACTIVE span (None outside any span): how an
    inner layer (the predict dispatch) hands the transport's server span to
    the batcher, so the request's timeline joins the node spans' trace.
    ``ingress`` defaults to the active span's name."""
    s = _current_span.get()
    if s is None:
        return None
    return TraceContext(trace_id=s.trace_id, parent_span_id=s.span_id, sampled=s.sampled,
                        ingress=ingress or s.name)


class Tracer:
    def __init__(self, service_name: str = "seldon-tpu", enabled: bool = False,
                 max_buffer: int = 4096):
        self.service_name = service_name
        self.enabled = enabled
        self._buffer: List[Span] = []
        self._lock = threading.Lock()
        self._max_buffer = max_buffer
        self.exporter = None  # callable(List[Span]) or None
        # what MetricsRegistry.sync_tracing reads at a scrape: spans dropped
        # by failed exports (a batch is re-enqueued once; the second failure
        # drops it), each flush's export wall, the request trees the flight
        # recorder retained by sampling mode
        self.spans_dropped_total = 0
        self._export_times: Any = deque(maxlen=512)
        self.retained_total: Dict[str, int] = {"head": 0, "tail": 0}
        # no anchor() here: the span clock anchors once at import, and
        # re-anchoring would shift the duration of every span open across
        # this construction

    @contextlib.contextmanager
    def span(self, name: str, traceparent: Optional[str] = None, **tags: Any):
        if not self.enabled:
            yield None
            return
        parent = _current_span.get()
        sampled = True
        if traceparent and parent is None:
            parsed = _parse_traceparent(traceparent)
            if parsed is None:
                trace_id, parent_id = secrets.token_hex(16), None
            else:
                trace_id, parent_id, sampled = parsed
        elif parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
            sampled = parent.sampled
        else:
            trace_id, parent_id = secrets.token_hex(16), None
        s = Span(name=name, trace_id=trace_id, span_id=secrets.token_hex(8), parent_id=parent_id,
                 tags=dict(tags), sampled=sampled)
        token = _current_span.set(s)
        try:
            yield s
        finally:
            s.finish()
            _current_span.reset(token)
            self._record(s)

    def _append(self, spans: List[Span]) -> None:
        """Buffer finished spans without network I/O on the recording
        thread (the batcher loop, a transport handler): with an exporter
        installed the PeriodicFlusher's thread owns the flush, and what a
        full buffer cannot hold is dropped and counted. Without one the
        flush is local (``TRACING_LOG``, or discard) and stays inline."""
        with self._lock:
            if self.exporter is not None:
                space = self._max_buffer - len(self._buffer)
                kept = spans[:space] if space > 0 else []
                self._buffer.extend(kept)
                self.spans_dropped_total += len(spans) - len(kept)
                return
            self._buffer.extend(spans)
            flush_now = len(self._buffer) >= self._max_buffer
        if flush_now:  # outside the lock: flush() takes it
            self.flush()

    def _record(self, s: Span) -> None:
        if not s.sampled:
            return  # head sampling: an unsampled span propagates its context only
        self._append([s])

    def record_spans(self, spans: List[Span]) -> None:
        """Append finished spans (the flight recorder's request trees); the
        caller decided retention, so sampled flags are taken as they are."""
        if not self.enabled or not spans:
            return
        self._append(list(spans))

    def count_retained(self, mode: str) -> None:
        """One request trace retained: ``head`` (the inbound flag said keep)
        or ``tail`` (kept past an unsampled flag by the tail thresholds)."""
        with self._lock:
            self.retained_total[mode] = self.retained_total.get(mode, 0) + 1

    def flush(self) -> None:
        with self._lock:
            spans, self._buffer = self._buffer, []
        if not spans:
            return
        if self.exporter is not None:
            t0 = time.perf_counter()
            try:
                self.exporter(spans)
            except Exception:  # the flusher's boundary: count, keep running
                logger.exception("trace export failed")
                # each span gets one retry, and a re-enqueue never pushes the
                # buffer past max_buffer
                retry = [s for s in spans if not s.requeued]
                dropped = len(spans) - len(retry)
                for s in retry:
                    s.requeued = True
                with self._lock:
                    space = max(self._max_buffer - len(self._buffer), 0)
                    kept, overflow = retry[:space], retry[space:]
                    # re-enqueued spans go ahead of those recorded since
                    self._buffer[:0] = kept
                    self.spans_dropped_total += dropped + len(overflow)
            finally:
                with self._lock:
                    self._export_times.append(time.perf_counter() - t0)
        elif os.environ.get("TRACING_LOG", ""):
            for s in spans:
                logger.info("span %s", json.dumps(s.to_dict()))

    def export_stats(self) -> Dict[str, Any]:
        """Drain-and-snapshot for ``MetricsRegistry.sync_tracing``: the
        flushes' export walls since the last scrape (each observed once)
        and the lifetime dropped / retained tallies."""
        with self._lock:
            times = list(self._export_times)
            self._export_times.clear()
            return {"export_times_s": times, "spans_dropped_total": self.spans_dropped_total,
                    "retained_total": dict(self.retained_total)}

    def drain(self) -> List[Span]:
        with self._lock:
            spans, self._buffer = self._buffer, []
        return spans


_HEX = frozenset("0123456789abcdefABCDEF")


def _parse_traceparent(header: str) -> Optional[Tuple[str, str, bool]]:
    """Strict W3C ``traceparent`` parse: ``version-traceid-spanid-flags``
    of 2 / 32 / 16 / 2 hex digits, version not ``ff``, ids not all zero;
    version 00 has exactly four fields, a later version may append more.
    (trace_id, span_id, sampled) or None: a malformed header starts a fresh
    trace at the caller rather than adopting ids a compliant parser
    downstream would reject."""
    if not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    if parts[0] == "00" and len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16 or len(flags) != 2:
        return None
    # a charset check, not int(x, 16), which takes signs and whitespace
    if not all(set(f) <= _HEX for f in (version, trace_id, span_id, flags)):
        return None
    if version.lower() == "ff":
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id.lower(), span_id.lower(), bool(int(flags, 16) & 0x01)


def tail_thresholds(env: Optional[dict] = None) -> Tuple[Optional[float], Optional[float]]:
    """The tail-sampling thresholds in seconds, (TTFT, worst inter-token
    gap), from ``TRACING_TAIL_TTFT_MS`` / ``TRACING_TAIL_GAP_MS``; None for
    one unset, unparsable or negative (that signal never tail-retains)."""
    env = env if env is not None else os.environ

    def ms(key: str) -> Optional[float]:
        raw = env.get(key, "")
        if not raw:
            return None
        try:
            v = float(raw)
        except (TypeError, ValueError):
            return None
        return v / 1000.0 if v >= 0 else None

    return ms("TRACING_TAIL_TTFT_MS"), ms("TRACING_TAIL_GAP_MS")


_tracer: Optional[Tracer] = None


def get_tracer() -> Tracer:
    """The process's tracer, built on first use from the environment
    (``TRACING=1``, ``JAEGER_SERVICE_NAME``; an OTLP endpoint installs the
    exporter and its flusher, which flushes once more at exit)."""
    global _tracer
    if _tracer is None:
        _tracer = Tracer(service_name=os.environ.get("JAEGER_SERVICE_NAME", "seldon-tpu"),
                         enabled=os.environ.get("TRACING", "0") == "1")
        from seldon_core_tpu_torch.tracing import export as _export

        flusher = _export.install_from_env(_tracer)
        if flusher is not None:
            import atexit

            atexit.register(flusher.stop)
    return _tracer


def set_tracer(tracer: Tracer) -> None:
    global _tracer
    _tracer = tracer


__all__ = ["Span", "TraceContext", "Tracer", "anchor", "current_trace_context",
           "current_traceparent", "get_tracer", "ingress_trace", "now", "set_tracer",
           "tail_thresholds"]
