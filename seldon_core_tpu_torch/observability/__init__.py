"""Observability of the port: the ``/debug/timeline`` report
(``timeline.py``)."""
