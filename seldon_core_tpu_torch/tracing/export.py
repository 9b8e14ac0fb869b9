"""Span export of the port (copied from ``seldon_core_tpu/tracing/export.py``):
the tracer's buffer to a collector as OTLP/HTTP JSON, built by hand (the
card's machine has no opentelemetry SDK and no aiohttp), POSTed with the
standard library's ``urllib.request`` to ``<endpoint>/v1/traces``.

Wiring: ``TRACING=1`` and ``OTEL_EXPORTER_OTLP_ENDPOINT=http://host:4318``
(or ``TRACING_OTLP_ENDPOINT``) install the exporter on the process's tracer
with a background flusher. Failures are accounted in ``Tracer.flush``: a
failed batch is re-enqueued once, a second failure drops it into
``seldon_trace_spans_dropped_total``, and every flush's wall lands in
``seldon_trace_export_seconds``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import urllib.request
from typing import List, Optional

from seldon_core_tpu_torch.tracing import Span, Tracer

logger = logging.getLogger(__name__)


def spans_to_otlp(spans: List[Span], service_name: str) -> dict:
    """Spans as an OTLP/HTTP JSON trace service request."""

    def attr(key: str, value) -> dict:
        if isinstance(value, bool):
            return {"key": key, "value": {"boolValue": value}}
        if isinstance(value, int):
            return {"key": key, "value": {"intValue": str(value)}}
        if isinstance(value, float):
            return {"key": key, "value": {"doubleValue": value}}
        return {"key": key, "value": {"stringValue": str(value)}}

    otlp_spans = []
    for s in spans:
        start_ns = int(s.start * 1e9)
        end_ns = max(int((s.end if s.end is not None else s.start) * 1e9), start_ns)
        span = {"traceId": s.trace_id, "spanId": s.span_id, "name": s.name,
                "kind": 2,  # SPAN_KIND_SERVER: request-scoped spans
                "startTimeUnixNano": str(start_ns), "endTimeUnixNano": str(end_ns),
                "attributes": [attr(k, v) for k, v in s.tags.items()]}
        if s.parent_id:
            span["parentSpanId"] = s.parent_id
        otlp_spans.append(span)
    return {"resourceSpans": [{
        "resource": {"attributes": [attr("service.name", service_name)]},
        "scopeSpans": [{"scope": {"name": "seldon-core-tpu"}, "spans": otlp_spans}]}]}


class OTLPExporter:
    """``Tracer.exporter``: POST the spans as OTLP JSON; a non-2xx answer
    raises."""

    def __init__(self, endpoint: str, service_name: str = "seldon-tpu", timeout_s: float = 5.0):
        self.url = endpoint.rstrip("/") + "/v1/traces"
        self.service_name = service_name
        self.timeout_s = timeout_s

    def __call__(self, spans: List[Span]) -> None:
        body = json.dumps(spans_to_otlp(spans, self.service_name)).encode()
        req = urllib.request.Request(self.url, data=body,
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            if resp.status >= 300:
                raise RuntimeError(f"OTLP export HTTP {resp.status}")


class PeriodicFlusher:
    """A daemon thread flushing the tracer every ``interval_s``, and once
    more at ``stop``."""

    def __init__(self, tracer: Tracer, interval_s: float = 5.0):
        self.tracer = tracer
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "PeriodicFlusher":
        self._thread = threading.Thread(target=self._run, daemon=True, name="seldon-trace-flush")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tracer.flush()
        self.tracer.flush()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self.interval_s + 1)


def install_from_env(tracer: Tracer, env: Optional[dict] = None) -> Optional[PeriodicFlusher]:
    """With an OTLP endpoint configured and the tracer on, attach an
    exporter and start its flusher (returned); else None."""
    env = env if env is not None else dict(os.environ)
    endpoint = env.get("OTEL_EXPORTER_OTLP_ENDPOINT") or env.get("TRACING_OTLP_ENDPOINT")
    if not endpoint or not tracer.enabled:
        return None
    tracer.exporter = OTLPExporter(endpoint, service_name=tracer.service_name)
    logger.info("OTLP trace export -> %s", tracer.exporter.url)
    return PeriodicFlusher(tracer).start()


__all__ = ["OTLPExporter", "PeriodicFlusher", "install_from_env", "spans_to_otlp"]
