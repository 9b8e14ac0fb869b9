"""Method dispatch: SeldonMessage in -> component call -> SeldonMessage out.

Port of ``seldon_core_tpu/components/dispatch.py`` (the reference's
`python/seldon_core/seldon_methods.py:11-229`), shared by the REST and gRPC
component servers and the graph engine. For each method: prefer the
component's ``*_raw`` hook, else extract the payload, call the high-level
method and build the response with the reference's encoding rules. A
single-prompt jsonData predict to a component with ``continuous_batching``
slots joins its shared continuous batch
(``runtime/batcher.get_batcher_service``), from whichever transport or the
engine; the calling thread blocks on its request.

A component method that returns an awaitable (a coroutine, an async
``__call__``) gives an awaitable here, which the engine awaits; the
transports drive it to its end on their own thread (``resolve``).
"""

from __future__ import annotations

import asyncio
import inspect
import os
from typing import Any, List, Optional, Sequence

import numpy as np

from seldon_core_tpu_torch.codec.response import construct_response, response_meta
from seldon_core_tpu_torch.components.component import (client_aggregate, client_predict,
                                                        client_route, client_send_feedback,
                                                        client_transform_input,
                                                        client_transform_output, has_raw)
from seldon_core_tpu_torch.contracts.payload import (Feedback, SeldonError, SeldonMessage,
                                                     SeldonMessageList)


def _coerce_raw(component: Any, result: Any, request: Optional[SeldonMessage],
                is_request: bool):
    """Normalize a ``*_raw`` return into a SeldonMessage (an awaitable one
    when the hook returned an awaitable)."""
    if inspect.isawaitable(result):
        async def _await():
            return _coerce_raw(component, await result, request, is_request)

        return _await()
    if isinstance(result, SeldonMessage):
        return result
    if isinstance(result, dict):
        return SeldonMessage.from_dict(result)
    return construct_response(component, is_request, request, result)


def _respond(component: Any, is_request: bool, request, result):
    """``construct_response``, awaiting first a result that is awaitable (a
    sync method delegating to an async one)."""
    if inspect.isawaitable(result):
        async def _await():
            return construct_response(component, is_request, request, await result)

        return _await()
    return construct_response(component, is_request, request, result)


def predict(component: Any, request: SeldonMessage):
    """The component's prediction for ``request`` as a SeldonMessage."""
    if has_raw(component, "predict"):
        return _coerce_raw(component, component.predict_raw(request), request, is_request=False)
    batched = _maybe_continuous_batch(component, request)
    if batched is not None:
        return batched
    payload = request.payload()
    result = client_predict(component, payload, request.names, meta=request.meta.to_dict())
    return _respond(component, False, request, result)


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

    from seldon_core_tpu_torch.tracing import current_trace_context, get_tracer

    svc = get_batcher_service(component)
    if svc is None:
        return None
    info: dict = {}
    # join the transport's trace: its server span is active here, so the
    # request's timeline roots under it (ingress: the span's name)
    trace = current_trace_context() if get_tracer().enabled else None
    kw = {"trace": trace} if trace is not None else {}
    toks = svc.submit_sync(body["prompt"], body.get("max_new_tokens"), info=info, **kw)
    tokenizer = getattr(component, "_tokenizer", None)
    text = (tokenizer.decode(toks) if tokenizer is not None and isinstance(body["prompt"], str)
            else None)
    msg = construct_response(component, False, request, {"texts": [text], "tokens": [toks]})
    if info.get("truncated_prompt"):
        # truncation changes outputs: tell the client, not just the log
        msg.meta.tags["seldon.io/truncated-prompt"] = info["truncated_prompt"]
    return msg


def transform_input(component: Any, request: SeldonMessage):
    if has_raw(component, "transform_input"):
        return _coerce_raw(component, component.transform_input_raw(request), request,
                           is_request=True)
    payload = request.payload()
    result = client_transform_input(component, payload, request.names,
                                    meta=request.meta.to_dict())
    return _respond(component, True, request, result)


def transform_output(component: Any, request: SeldonMessage):
    if has_raw(component, "transform_output"):
        return _coerce_raw(component, component.transform_output_raw(request), request,
                           is_request=False)
    payload = request.payload()
    result = client_transform_output(component, payload, request.names,
                                     meta=request.meta.to_dict())
    return _respond(component, False, request, result)


def route(component: Any, request: SeldonMessage):
    """A 1x1 ndarray-encoded branch index, as the reference answers
    (`seldon_methods.py:159-189`); the index must be an int >= -1."""
    if has_raw(component, "route"):
        msg = _coerce_raw(component, component.route_raw(request), request, is_request=False)
        if inspect.isawaitable(msg):
            async def _await():
                out = await msg
                _validate_route_msg(out)
                return out

            return _await()
        _validate_route_msg(msg)
        return msg
    payload = request.payload()
    branch = client_route(component, payload, request.names)
    if inspect.isawaitable(branch):
        async def _await():
            return _route_response(component, request, await branch)

        return _await()
    return _route_response(component, request, branch)


def _route_response(component: Any, request: SeldonMessage, branch) -> SeldonMessage:
    if not isinstance(branch, int) or isinstance(branch, bool):
        raise SeldonError("Routing response must be an integer")
    if branch < -1:
        raise SeldonError(f"Routing response invalid: {branch} (must be >= -1)")
    msg = construct_response(component, False, request, np.array([[branch]]))
    if msg.data is not None:
        msg.data.encoding = "ndarray"
        msg.data.raw_ndarray = [[branch]]
    return msg


def _validate_route_msg(msg: SeldonMessage) -> None:
    arr = msg.payload()
    if isinstance(arr, np.ndarray):
        flat = arr.ravel()
        if flat.size != 1 or int(flat[0]) < -1:
            raise SeldonError(f"Routing response invalid: {flat.tolist()}")


def extract_route(msg: SeldonMessage) -> int:
    arr = msg.payload()
    if isinstance(arr, np.ndarray):
        flat = arr.ravel()
        if flat.size == 1:
            return int(flat[0])
    raise SeldonError("Routing response must contain a single integer")


def aggregate(component: Any, requests: SeldonMessageList):
    if has_raw(component, "aggregate"):
        return _coerce_raw(component, component.aggregate_raw(requests.messages), None,
                           is_request=False)
    arrays: List[np.ndarray] = []
    names: List[Sequence[str]] = []
    for m in requests.messages:
        arrays.append(m.payload())
        names.append(m.names)
    result = client_aggregate(component, arrays, names)
    first = requests.messages[0] if requests.messages else None
    return _respond(component, False, first, result)


def send_feedback(component: Any, feedback: Feedback, unit_id: Optional[str] = None):
    """Deliver feedback. ``unit_id`` selects this unit's routing decision
    from the response's meta (the reference reads env PREDICTIVE_UNIT_ID,
    `seldon_methods.py:52-90`)."""
    if has_raw(component, "send_feedback"):
        raw = component.send_feedback_raw(feedback)
        if raw is None:
            return SeldonMessage(meta=response_meta(component, None))
        return _coerce_raw(component, raw, feedback.request, is_request=False)
    features: Optional[np.ndarray] = None
    feature_names: Sequence[str] = []
    if feedback.request is not None:
        features = feedback.request.payload()
        feature_names = feedback.request.names
    truth = feedback.truth.payload() if feedback.truth is not None else None
    routing: Optional[int] = None
    uid = unit_id if unit_id is not None else os.environ.get("PREDICTIVE_UNIT_ID", "")
    if feedback.response is not None and uid:
        routing = feedback.response.meta.routing.get(uid)
    result = client_send_feedback(component, features, feature_names, feedback.reward, truth,
                                  routing)

    def respond(value):
        if value is None:
            return SeldonMessage(meta=response_meta(component, None))
        return construct_response(component, False, feedback.request, value)

    if inspect.isawaitable(result):
        async def _await():
            return respond(await result)

        return _await()
    return respond(result)


def resolve(result: Any) -> Any:
    """A dispatch result, an awaitable one driven to its end on the
    calling thread (a transport thread, which runs no event loop)."""
    if not inspect.isawaitable(result):
        return result

    async def wait():
        return await result

    return asyncio.run(wait())


__all__ = ["aggregate", "extract_route", "predict", "resolve", "route", "send_feedback",
           "transform_input", "transform_output"]
