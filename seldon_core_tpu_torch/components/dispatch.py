"""Method dispatch: SeldonMessage in -> component call -> SeldonMessage out.

Port of ``seldon_core_tpu/components/dispatch.py`` for the one-model predict
slice: ``predict`` prefers the component's ``predict_raw`` hook, else
extracts the payload, calls ``predict`` and builds the response with the
reference's encoding rules. The JAX package's other methods (transform,
route, aggregate, feedback) and the hook that lets a single-prompt predict
join an LLM's continuous batch arrive with the engine slice.
"""

from __future__ import annotations

from typing import Any, Optional

from seldon_core_tpu_torch.codec.response import construct_response
from seldon_core_tpu_torch.components.component import client_predict, has_raw
from seldon_core_tpu_torch.contracts.payload import SeldonMessage


def _coerce_raw(component: Any, result: Any, request: Optional[SeldonMessage],
                is_request: bool) -> SeldonMessage:
    """Normalize a ``*_raw`` return into a SeldonMessage."""
    if isinstance(result, SeldonMessage):
        return result
    if isinstance(result, dict):
        return SeldonMessage.from_dict(result)
    return construct_response(component, is_request, request, result)


def predict(component: Any, request: SeldonMessage) -> SeldonMessage:
    """The component's prediction for ``request`` as a SeldonMessage."""
    if has_raw(component, "predict"):
        return _coerce_raw(component, component.predict_raw(request), request, is_request=False)
    payload = request.payload()
    result = client_predict(component, payload, request.names, meta=request.meta.to_dict())
    return construct_response(component, False, request, result)


__all__ = ["predict"]
