"""``/debug/timeline`` of the port (copied from
``seldon_core_tpu/observability/timeline.py``): the recent per-request
flight-recorder timelines and the aggregated scaling snapshot.

The REST route (``transport/rest.py``, on the component and the engine
apps) and its gRPC mirror (``Model/DebugTimeline``,
``transport/grpc_server.py``) both render through :func:`timeline_report`,
so the two cannot drift. The scaling block is what a scale controller
reads: queue depth by class, slot occupancy, page pressure, sheds, the
handoff queue, the device split, and the recorder's TTFT / queue-wait /
worst-gap quantiles. Read-only: unlike ``llm_stats`` (which drains its
deques into the scrape's histograms) nothing here is consumed, so polling
it never starves ``/metrics``. The dynamic ``Retry-After`` lives in
``runtime/resilience.py`` (``retry_after_hint``, ``wire_retry_after``).
"""

from __future__ import annotations

from typing import Any, Optional

from seldon_core_tpu_torch.tracing import get_tracer


def parse_n(raw: Any, default: int = 32) -> int:
    """The ``?n=`` / jsonData ``n`` of every timeline surface: an int, else
    ``default``."""
    try:
        return int(raw)
    except (TypeError, ValueError):
        return default


def _batcher(component: Any):
    svc = getattr(component, "_batcher_service", None)
    return None if svc is None else svc.batcher


def _recorder(component: Any, batcher: Any):
    fn = getattr(component, "flight_recorder", None)
    if fn is not None:
        return fn()
    return getattr(batcher, "_flight", None) if batcher is not None else None


def timeline_report(component: Any, n: int = 32) -> dict:
    """The ``/debug/timeline`` payload of one component. Without a batcher,
    or with tracing off, ``tracing`` is false and the timeline list empty:
    the route never fails on configuration."""
    batcher = _batcher(component)
    recorder = _recorder(component, batcher)
    out: dict = {"tracing": recorder is not None, "tracer_enabled": get_tracer().enabled,
                 "timelines": [], "scaling": scaling_snapshot(component, batcher, recorder)}
    if recorder is not None:
        out["timelines"] = recorder.timelines(n)
    return out


def scaling_snapshot(component: Any, batcher: Any = None, recorder: Optional[Any] = None) -> dict:
    """Load state and request-latency quantiles; zeros for what a bare
    component lacks. The queue depth and its per-class split come from one
    read of the scheduler, so they agree."""
    if batcher is None:
        batcher = _batcher(component)
    if recorder is None:
        recorder = _recorder(component, batcher)
    snap: dict = {
        "active_slots": 0,
        "total_slots": 0,
        "queue_depth": 0,
        "steps_in_flight": 0,
        "page_pressure": 0.0,
        "page_sheds_total": 0,
        "handoff_queue_depth": 0,
        "draining": False,
        # a replica fleet's quarantine of this replica (a solo component is
        # never ejected)
        "ejected": False,
        "prefill_devices": 0,
        "decode_devices": 0,
        "queue_by_class": {},
    }
    if batcher is not None:
        snap["active_slots"] = sum(1 for s in batcher._slots if s.active)
        snap["total_slots"] = batcher.S
        by_class = batcher._pending.depths()
        snap["queue_by_class"] = by_class
        snap["queue_depth"] = sum(by_class.values())
        snap["steps_in_flight"] = len(batcher._inflight)
        snap["draining"] = bool(getattr(batcher, "draining", False))
        pages = batcher.page_stats()
        snap["page_pressure"] = pages["kv_pages_in_use"] / max(pages["kv_pages_total"], 1)
        snap["page_sheds_total"] = pages["kv_page_sheds"]
        if batcher._remote is not None:
            snap["handoff_queue_depth"] = batcher.handoff_stats()["handoff_queue_depth"]
            mesh = batcher.disagg_mesh
            if mesh is not None:
                snap["prefill_devices"] = len(mesh.prefill_devices)
                snap["decode_devices"] = len(mesh.decode_devices)
    if recorder is not None:
        snap["requests"] = recorder.snapshot()
    return snap


__all__ = ["parse_n", "scaling_snapshot", "timeline_report"]
