"""Load shedding error of the port.

Copied from ``seldon_core_tpu/runtime/resilience.py`` (``ShedError``): the
batcher raises it when the KV page pool is exhausted, and the REST layer
renders it as 503 with a ``Retry-After`` header. Deadlines and the admission
controller stay with the JAX package until a later slice ports them.
"""

from __future__ import annotations

from seldon_core_tpu_torch.contracts.payload import SeldonError

DEFAULT_RETRY_AFTER_S = 1


class ShedError(SeldonError):
    """Request shed at admission: server at capacity and queue full."""

    def __init__(self, message: str, retry_after_s: float = DEFAULT_RETRY_AFTER_S):
        super().__init__(message, status_code=503, reason="RESOURCE_EXHAUSTED")
        self.retry_after_s = retry_after_s


__all__ = ["DEFAULT_RETRY_AFTER_S", "ShedError"]
