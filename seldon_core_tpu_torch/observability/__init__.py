"""Observability of the port: the ``/debug/timeline`` report
(``timeline.py``), the request logger service (``request_logger.py``) and
the Prometheus / Grafana artifacts (``dashboards.py``)."""
