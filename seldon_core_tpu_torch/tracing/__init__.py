"""The port's tracer: a no-op stand-in for ``seldon_core_tpu/tracing``.

The graph engine opens a span per node (``get_tracer().span(...)``); here
every span is a null context manager, so a node costs one call, and
``current_traceparent()`` is None, so a remote hop sends no
``traceparent``. The real tracer (W3C ``traceparent``, the flight recorder,
``/debug/timeline``) comes with the tracing slice of the port.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Optional


class NoopTracer:
    """A tracer that records nothing."""

    def span(self, name: str, **attributes):
        return nullcontext()


_TRACER = NoopTracer()


def get_tracer() -> NoopTracer:
    return _TRACER


def current_traceparent() -> Optional[str]:
    """The active span's W3C ``traceparent``: None, as no span records."""
    return None


__all__ = ["NoopTracer", "current_traceparent", "get_tracer"]
