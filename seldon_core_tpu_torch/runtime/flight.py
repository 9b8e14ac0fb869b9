"""The batcher's flight recorder, ported to the port (copied from
``seldon_core_tpu/runtime/flight.py``; the port imports nothing of the JAX
package): request-scoped timelines through the serving loop.

The histograms (TTFT, inter-token gap, handoff wall) say that a tail
exists; the recorder says why one request saw it. Each slot holds a
bounded ring of timestamped lifecycle events: admission (with its queue
wait), each prefill chunk, the handoff stages of a remote admission, each
drained decode step with its tokens (and a verify's offered and accepted
drafts), page growth, sheds, the resume of a fleet recovery, the first
token. The batcher writes them where it already touches host state, from
host stamps it already has: no event reads a device value, so tracing adds
no sync to a graph replay. At completion a request's ring materializes into
one timeline (served at ``/debug/timeline`` and gRPC ``DebugTimeline``) and
one span tree (fed to the tracer, exported over OTLP).

Concurrency:

- The per-slot segments and their rings have ONE writer: the batcher's
  loop thread, which owns all slot bookkeeping, calls ``begin`` /
  ``record`` / ``extend`` / ``complete``. No lock is taken per event.
- A prefill worker never touches a slot ring: it stamps its events into
  the ``Handoff`` before it publishes it through the TransferQueue (the
  queue's lock moves ownership), and the loop copies them in at consume
  time (``extend``).
- Only the completed-timeline ring and the aggregates cross threads (the
  ``/debug/timeline`` and scrape readers); ``_lock`` guards them, taken
  once a request, at completion.

Tracing off: the batcher holds no recorder (``_flight`` is None), every
hook is a None check, and no program or graph changes either way.
"""

from __future__ import annotations

import random
import secrets
import threading
import time
from collections import deque
from typing import Any, List, Optional

from seldon_core_tpu_torch.tracing import Span, TraceContext, Tracer
from seldon_core_tpu_torch.tracing import now as wall_now

# event kinds (a timeline event's "kind", a span's name after "llm."); the
# queue wait is a segment field (begin()), not an event
EV_PREFILL_CHUNK = "prefill_chunk"      # one chunked-prefill dispatch (host enqueue wall)
EV_PREFILL = "prefill"                  # one-shot dense prefill
EV_PREFIX_HIT = "prefix_hit"            # radix hit: tokens matched, block entries shared
EV_FIRST_TOKEN = "first_token"          # commit: the prefill-sampled token surfaced
EV_STEP = "step"                        # a drained decode step credited to a slot
EV_PAGE_GROW = "page_grow"              # mid-decode page allocation
EV_HANDOFF_STAGED = "handoff_staged"    # remote job staged
EV_HANDOFF_COMPUTE = "handoff_compute"  # the worker's prefill (host wall)
EV_HANDOFF_TRANSFER = "handoff_transfer"  # the bucket's move to the decode side
EV_HANDOFF_IMPORT = "handoff_import"    # the decode side's page import (host wall)
EV_SHED = "shed"                        # request shed (503 + Retry-After) or preempted
EV_RESUME = "resume"                    # fleet recovery: re-admitted after N delivered tokens

DEFAULT_RING = 512   # events per in-flight request
DEFAULT_KEEP = 64    # completed timelines kept for /debug/timeline


class _Segment:
    """One request's in-flight recording: its trace identity and event
    ring. ``total`` counts every append, so ring overflow shows
    (``events_dropped`` = total - len(ring)). TTFT, the worst gap and the
    token count accumulate here at record time, not from the ring: a
    generation longer than the ring evicts its early events, and reading
    TTFT from the ring would lose it for exactly the long slow requests."""

    __slots__ = ("trace", "t_submit", "t_begin", "prompt_tokens", "ring", "total", "t_first",
                 "last_surface", "worst_gap", "tokens", "tags")

    def __init__(self, trace: TraceContext, t_submit: Optional[float], t_begin: float,
                 prompt_tokens: int, ring_size: int, tags: Optional[dict] = None):
        # request identity (tenant / slo_class / adapter_id), merged into the
        # timeline and the root span's tags
        self.tags = tags
        self.trace = trace
        self.t_submit = t_submit if t_submit is not None else t_begin
        self.t_begin = t_begin
        self.prompt_tokens = prompt_tokens
        self.ring: Any = deque(maxlen=ring_size)
        self.total = 0
        self.t_first: Optional[float] = None
        self.last_surface: Optional[float] = None
        self.worst_gap: Optional[float] = None
        self.tokens = 0


class FlightRecorder:
    """See the module docstring. ``clock`` is the batcher's timestamp source
    (``time.perf_counter``: ``submit``'s arrival and a dispatch's
    ``t_dispatch`` come from it); materialization maps it to wall time
    through an anchor pair refreshed at every completion."""

    def __init__(self, n_slots: int, ring_size: int = DEFAULT_RING, keep: int = DEFAULT_KEEP,
                 tail_ttft_s: Optional[float] = None, tail_gap_s: Optional[float] = None,
                 clock=time.perf_counter):
        self.n_slots = int(n_slots)
        self.ring_size = int(ring_size)
        self.tail_ttft_s = tail_ttft_s
        self.tail_gap_s = tail_gap_s
        self._clock = clock
        # perf-counter -> wall anchor through tracing.now(), refreshed at
        # each materialization (_reanchor), so a tracing.anchor() correction
        # reaches the recorder's timestamps too
        self._wall0 = wall_now()
        self._perf0 = clock()
        self._segs: List[Optional[_Segment]] = [None] * self.n_slots
        # the cross-thread side: completed timelines and the aggregates
        self._lock = threading.Lock()
        self._completed: Any = deque(maxlen=int(keep))
        self.completed_total = 0
        self.retained = {"head": 0, "tail": 0, "drop": 0}
        self.events_dropped_total = 0
        self._ttft: Any = deque(maxlen=256)
        self._queue_wait: Any = deque(maxlen=256)
        self._worst_gap: Any = deque(maxlen=256)
        # span and trace ids from a PRNG seeded once from the system's
        # entropy (ids need uniqueness, not secrecy; a urandom read an id
        # would cost ~40 syscalls a request); used from the loop thread only
        self._id_rng = random.Random(secrets.randbits(64))

    def _span_id(self) -> str:
        return f"{self._id_rng.getrandbits(64):016x}"

    def _trace_id(self) -> str:
        return f"{self._id_rng.getrandbits(128):032x}"

    # -- the writer's side (the batcher loop only) ------------------------
    def begin(self, slot: int, trace: Optional[TraceContext], t_submit: Optional[float],
              prompt_tokens: int, tags: Optional[dict] = None) -> None:
        """Start recording a request when its slot is chosen. A None
        ``trace`` (an untraced submit) still records, under a fresh trace
        id, so ``/debug/timeline`` sees every request."""
        if trace is None:
            trace = TraceContext(trace_id=self._trace_id(), sampled=True, ingress="internal")
        self._segs[slot] = _Segment(trace, t_submit, self._clock(), prompt_tokens,
                                    self.ring_size, tags=tags)

    def record(self, slot: int, kind: str, **fields: Any) -> None:
        seg = self._segs[slot]
        if seg is None:
            return
        seg.total += 1
        t = self._clock()
        if kind == EV_FIRST_TOKEN or kind == EV_STEP:
            seg.tokens += int(fields.get("tokens", 0))
            if seg.t_first is None and kind == EV_FIRST_TOKEN:
                seg.t_first = t
            if seg.last_surface is not None:
                gap = t - seg.last_surface
                if seg.worst_gap is None or gap > seg.worst_gap:
                    seg.worst_gap = gap
            seg.last_surface = t
        seg.ring.append((t, kind, fields))

    def extend(self, slot: int, events) -> None:
        """Copy a worker's events (``Handoff.events``: (t, kind, fields) on
        this process's perf_counter clock) into the slot's ring."""
        seg = self._segs[slot]
        if seg is None:
            return
        for t, kind, fields in events:
            seg.total += 1
            seg.ring.append((t, kind, fields))

    def complete(self, slot: int, status: str, tokens: int,
                 tracer: Optional[Tracer] = None) -> Optional[dict]:
        """Materialize the slot's segment into a timeline and a span tree:
        decide retention (the head flag, else the tail thresholds), feed a
        retained tree to ``tracer``, publish the timeline and clear the
        segment. The only lock the writer takes, once a request."""
        seg = self._segs[slot]
        if seg is None:
            return None
        self._segs[slot] = None
        self._reanchor()
        t_end = self._clock()
        events = list(seg.ring)
        timeline = self._materialize(seg, events, slot, status, tokens, t_end)
        mode = timeline["sampling"]
        if tracer is not None and tracer.enabled and mode != "drop":
            tracer.record_spans(self._spans(seg, events, timeline, t_end))
            tracer.count_retained(mode)
        dropped = seg.total - len(events)
        with self._lock:
            self._completed.append(timeline)
            self.completed_total += 1
            self.retained[mode] = self.retained.get(mode, 0) + 1
            self.events_dropped_total += dropped
            if timeline["ttft_s"] is not None:
                self._ttft.append(timeline["ttft_s"])
            self._queue_wait.append(timeline["queue_wait_s"])
            if timeline["worst_gap_s"] is not None:
                self._worst_gap.append(timeline["worst_gap_s"])
        return timeline

    def live_slots(self) -> List[int]:
        """The slots with a segment still open (none once the loop is idle
        or its crash path has run)."""
        return [i for i, s in enumerate(self._segs) if s is not None]

    # -- materialization ---------------------------------------------------
    def _reanchor(self) -> None:
        self._wall0 = wall_now()
        self._perf0 = self._clock()

    def _wall(self, t: float) -> float:
        return self._wall0 + (t - self._perf0)

    def _materialize(self, seg: _Segment, events, slot: int, status: str, tokens: int,
                     t_end: float) -> dict:
        ttft = (seg.t_first - seg.t_submit) if seg.t_first is not None else None
        worst_gap = seg.worst_gap
        if seg.trace.sampled:
            mode = "head"
        elif (self.tail_ttft_s is not None and ttft is not None and ttft > self.tail_ttft_s) \
                or (self.tail_gap_s is not None and worst_gap is not None
                    and worst_gap > self.tail_gap_s):
            mode = "tail"
        else:
            mode = "drop"
        return {
            "trace_id": seg.trace.trace_id,
            "ingress": seg.trace.ingress,
            "slot": slot,
            "status": status,
            **({"request_tags": dict(seg.tags)} if seg.tags else {}),
            "sampling": mode,
            "t_submit_wall": self._wall(seg.t_submit),
            "queue_wait_s": seg.t_begin - seg.t_submit,
            "ttft_s": ttft,
            "worst_gap_s": worst_gap,
            "total_s": t_end - seg.t_submit,
            "prompt_tokens": seg.prompt_tokens,
            "tokens": tokens,
            "token_events_sum": seg.tokens,
            "events_dropped": seg.total - len(events),
            "events": [self._event_dict(seg, t, kind, fields) for t, kind, fields in events],
        }

    @staticmethod
    def _event_dict(seg: _Segment, t: float, kind: str, fields: dict) -> dict:
        out = {"t_s": round(t - seg.t_submit, 6), "kind": kind}
        for k, v in fields.items():
            if k == "t_dispatch":
                # a raw perf-counter stamp means nothing to a client
                out["t_dispatch_s"] = round(float(v) - seg.t_submit, 6)
            else:
                out[k] = v
        return out

    def _spans(self, seg: _Segment, events, timeline: dict, t_end: float) -> List[Span]:
        """The request's span tree: a root at the transport ingress, a
        queue-wait child, a child per recorded event (a decode step spans
        dispatch to drain) and the decode span. A tail-retained tree
        detaches from the caller's span (head sampling dropped it, so a
        parent link would point at a span the collector never gets) and
        keeps it as a tag; every span of a retained tree is sampled."""
        trace = seg.trace
        head = timeline["sampling"] == "head"
        root_tags_extra = {}
        if not head and trace.parent_span_id:
            root_tags_extra["caller_span_id"] = trace.parent_span_id
        root = Span(
            name=f"llm.request {trace.ingress}".strip(), trace_id=trace.trace_id,
            span_id=self._span_id(), parent_id=trace.parent_span_id if head else None,
            start=self._wall(seg.t_submit), end=self._wall(t_end),
            tags={"slot": timeline["slot"], "status": timeline["status"],
                  "tokens": timeline["tokens"], "prompt_tokens": timeline["prompt_tokens"],
                  "sampling": timeline["sampling"],
                  "ttft_ms": round((timeline["ttft_s"] or 0.0) * 1e3, 3),
                  "worst_gap_ms": round((timeline["worst_gap_s"] or 0.0) * 1e3, 3),
                  "events_dropped": timeline["events_dropped"],
                  **(seg.tags or {}), **root_tags_extra})
        spans = [root, Span(name="queue.wait", trace_id=trace.trace_id, span_id=self._span_id(),
                            parent_id=root.span_id, start=self._wall(seg.t_submit),
                            end=self._wall(seg.t_begin), tags={})]
        decode_start = None
        for t, kind, fields in events:
            wall_t = self._wall(t)
            # a duration-bearing event spans [t - dur, t]; an instant is a point
            start = wall_t - float(fields.get("dur_s", 0.0) or 0.0)
            if kind == EV_STEP and "t_dispatch" in fields:
                start = self._wall(float(fields["t_dispatch"]))
            if kind == EV_FIRST_TOKEN and decode_start is None:
                decode_start = t
            tags = {k: v for k, v in fields.items() if k not in ("dur_s", "t_dispatch")}
            spans.append(Span(name=f"llm.{kind}", trace_id=trace.trace_id,
                              span_id=self._span_id(), parent_id=root.span_id, start=start,
                              end=wall_t, tags=tags))
        if decode_start is not None:
            spans.append(Span(name="llm.decode", trace_id=trace.trace_id,
                              span_id=self._span_id(), parent_id=root.span_id,
                              start=self._wall(decode_start), end=self._wall(t_end),
                              tags={"tokens": timeline["tokens"]}))
        for s in spans:
            s.sampled = True  # retention already decided
        return spans

    # -- the readers' side --------------------------------------------------
    def timelines(self, n: int = DEFAULT_KEEP) -> List[dict]:
        """The ``n`` most recent completed timelines, newest last (none for
        n <= 0: the raw ``?n=`` may be negative)."""
        n = int(n)
        if n <= 0:
            return []
        with self._lock:
            items = list(self._completed)
        return items[-n:]

    def snapshot(self) -> dict:
        """The aggregated scaling signals: TTFT, queue wait and worst gap
        quantiles over recent requests, with the retention and drop
        tallies."""

        def stats(values) -> dict:
            if not values:
                return {"p50": None, "p95": None, "max": None}
            vs = sorted(values)
            return {"p50": vs[len(vs) // 2], "p95": vs[min(int(len(vs) * 0.95), len(vs) - 1)],
                    "max": vs[-1]}

        with self._lock:
            return {"completed_total": self.completed_total, "retained": dict(self.retained),
                    "events_dropped_total": self.events_dropped_total,
                    "ttft_s": stats(list(self._ttft)),
                    "queue_wait_s": stats(list(self._queue_wait)),
                    "worst_gap_s": stats(list(self._worst_gap))}


__all__ = ["DEFAULT_KEEP", "DEFAULT_RING", "EV_FIRST_TOKEN", "EV_HANDOFF_COMPUTE",
           "EV_HANDOFF_IMPORT", "EV_HANDOFF_STAGED", "EV_HANDOFF_TRANSFER", "EV_PAGE_GROW",
           "EV_PREFILL", "EV_PREFILL_CHUNK", "EV_PREFIX_HIT", "EV_RESUME", "EV_SHED", "EV_STEP",
           "FlightRecorder"]
