"""In-band custom metric helpers, copied from
``seldon_core_tpu/components/metrics.py``.

Components return a list of metric dicts from ``metrics()``; they travel in
the response's ``meta.metrics`` and the engine app registers them
(``metrics/registry.register_custom``) — the reference's metrics-in-the-
payload design (`python/seldon_core/metrics.py:8-89`,
`proto/prediction.proto:48-58`). The schema check is
``components.component.validate_metrics``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

COUNTER = "COUNTER"
GAUGE = "GAUGE"
TIMER = "TIMER"


def create_counter(key: str, value: float, tags: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    return _metric(key, COUNTER, value, tags)


def create_gauge(key: str, value: float, tags: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    return _metric(key, GAUGE, value, tags)


def create_timer(key: str, value: float, tags: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    return _metric(key, TIMER, value, tags)


def _metric(key: str, mtype: str, value: float, tags: Optional[Dict[str, str]]) -> Dict[str, Any]:
    d: Dict[str, Any] = {"key": key, "type": mtype, "value": value}
    if tags:
        d["tags"] = tags
    return d


__all__ = ["COUNTER", "GAUGE", "TIMER", "create_counter", "create_gauge", "create_timer"]
