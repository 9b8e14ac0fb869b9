"""SLO classes of the port's admission, copied from
``seldon_core_tpu/runtime/scheduler.py``: the class names and
``normalize_slo_class``, which the REST layer uses to refuse an unknown
class with 400 on every branch, as the JAX package does.

The port's batcher admits FIFO, which is what the default class
(``interactive``) is served by; the weighted-fair scheduler, tenants and
quotas arrive with the LoRA/tenants slice.
"""

from __future__ import annotations

INTERACTIVE = "interactive"
BATCH = "batch"
SLO_CLASSES = (INTERACTIVE, BATCH)


def normalize_slo_class(value) -> str:
    """Canonical SLO class; raises ValueError on anything else so a typo
    in a header fails loudly (400 at the transport) instead of silently
    landing in a default queue."""
    v = str(value or INTERACTIVE).strip().lower()
    if v in (INTERACTIVE, "latency"):
        return INTERACTIVE
    if v in (BATCH, "throughput", "bulk"):
        return BATCH
    raise ValueError(
        f"unknown SLO class {value!r}: expected one of {SLO_CLASSES}")


__all__ = ["BATCH", "INTERACTIVE", "SLO_CLASSES", "normalize_slo_class"]
