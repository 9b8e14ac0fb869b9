"""Method dispatch: SeldonMessage in -> component call -> SeldonMessage out.

Port of ``seldon_core_tpu/components/dispatch.py`` for the one-model predict
slice: ``predict`` prefers the component's ``predict_raw`` hook, else
extracts the payload, calls ``predict`` and builds the response with the
reference's encoding rules; a single-prompt jsonData predict to a
component with ``continuous_batching`` slots joins its shared continuous
batch (``runtime/batcher.get_batcher_service``). The JAX package's other
methods (transform, route, aggregate, feedback) arrive with the engine
slice.
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
    batched = _maybe_continuous_batch(component, request)
    if batched is not None:
        return batched
    payload = request.payload()
    result = client_predict(component, payload, request.names, meta=request.meta.to_dict())
    return construct_response(component, False, request, result)


def _maybe_continuous_batch(component: Any, request: SeldonMessage) -> Optional[SeldonMessage]:
    """A jsonData ``{"prompt": ..., "max_new_tokens": N}`` predict joins the
    component's shared continuous batch when it opted in
    (``continuous_batching`` slots > 0), so concurrent predict clients share
    one in-flight decode; the calling transport thread blocks on its
    request. The response has the unbatched path's shape
    (``{"texts": [...], "tokens": [[...]]}`` through construct_response,
    meta included). A body with ``prompts``, ``temperature`` or ``seed``
    keeps the private path, so its output never changes. None when the
    request does not join."""
    if int(getattr(component, "continuous_batching", 0) or 0) <= 0:
        return None
    if request.which != "jsonData" or not isinstance(request.json_data, dict):
        return None
    body = request.json_data
    if "prompt" not in body or "prompts" in body or "temperature" in body or "seed" in body:
        return None
    from seldon_core_tpu_torch.runtime.batcher import get_batcher_service

    svc = get_batcher_service(component)
    if svc is None:
        return None
    info: dict = {}
    toks = svc.submit_sync(body["prompt"], body.get("max_new_tokens"), info=info)
    tokenizer = getattr(component, "_tokenizer", None)
    text = (tokenizer.decode(toks) if tokenizer is not None and isinstance(body["prompt"], str)
            else None)
    msg = construct_response(component, False, request, {"texts": [text], "tokens": [toks]})
    if info.get("truncated_prompt"):
        # truncation changes outputs: tell the client, not just the log
        msg.meta.tags["seldon.io/truncated-prompt"] = info["truncated_prompt"]
    return msg


__all__ = ["predict"]
