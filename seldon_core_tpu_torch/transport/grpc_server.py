"""gRPC servers of the port: ``seldon_core_tpu/transport/grpc_server.py``'s
component server (``make_component_server`` / ``serve_component``) and
engine server (``make_engine_server`` / ``serve_engine``), the same services
and method tables as the JAX package, served through
``grpc.method_handlers_generic_handler`` over the copied stubs
(``transport/proto/prediction_pb2.py``).

The component server:

- ``Model/Predict`` through ``components/dispatch.predict``, so an LLM's
  single-prompt jsonData joins its shared batch and a ``TorchServer``
  answers as over REST; ``Generic``, ``Router``, ``Transformer``,
  ``OutputTransformer`` and ``Combiner``'s ``TransformInput``,
  ``TransformOutput``, ``Route``, ``Aggregate`` and ``SendFeedback``
  through the other dispatch methods;
- ``Model/GenerateStream`` (unary-stream): the SSE contract of
  ``/v1/generate`` on this transport — one jsonData ``{"token", "text"}``
  per token, then the ``done`` event, with the same INVALID_ARGUMENT
  rejections before the stream starts (``streaming.stream_service``); a
  replica fleet's resume is one jsonData ``{"resumed", "tokens_delivered"}``
  chunk, and its spent retry budget RESOURCE_EXHAUSTED;
- ``Model/DebugTimeline``: REST ``/debug/timeline``'s payload
  (``observability/timeline.timeline_report``) as jsonData; request jsonData
  ``{"n": K}`` bounds the timelines.

Tracing: the ``traceparent`` metadata key (the REST header's gRPC
spelling) roots each unary rpc's server span (``grpc:<rpc>``) and, for
``GenerateStream``, the request's flight-recorder trace; a traced stream
sends ``x-trace-id`` in its initial metadata, before the first token, and
``trace_id`` in its done event.

The engine server serves ``Seldon/Predict`` and ``Seldon/SendFeedback``
through a ``runtime/engine.GraphEngine`` on the gRPC worker thread
(``predict_sync``, under a ``grpc:predictions`` span): admission sheds RESOURCE_EXHAUSTED, and the call's
deadline (or ``seldon-deadline-ms`` metadata) spent before a node aborts
DEADLINE_EXCEEDED.

Tenant and SLO class ride the ``seldon-tenant`` / ``seldon-slo-class``
metadata (the jsonData fields win) under REST's rules, with the jsonData
``adapter`` and the call's deadline; a tenant over its quota is
RESOURCE_EXHAUSTED. The maximum message
size honours the ``seldon.io/grpc-max-message-size`` annotation. grpcio and
protobuf are imported with this module: the CLI names whichever is missing.
"""

from __future__ import annotations

import logging
import time
from concurrent import futures
from typing import Any, Callable, Dict, Optional

import grpc

from seldon_core_tpu_torch.components import dispatch
from seldon_core_tpu_torch.contracts.payload import SeldonError, SeldonMessage
from seldon_core_tpu_torch.metrics.registry import MetricsRegistry
from seldon_core_tpu_torch.observability.timeline import parse_n, timeline_report
from seldon_core_tpu_torch.runtime.resilience import (DEADLINE_GRPC_METADATA,
                                                      AdmissionController, Deadline, ShedError,
                                                      deadline_scope)
from seldon_core_tpu_torch.tracing import get_tracer, ingress_trace
from seldon_core_tpu_torch.transport import proto_convert as pc
from seldon_core_tpu_torch.transport.proto import prediction_pb2 as pb
from seldon_core_tpu_torch.transport.streaming import (TRACE_ID_HEADER, check_identity,
                                                       stream_events, stream_service)

logger = logging.getLogger(__name__)

ANNOTATION_GRPC_MAX_MSG_SIZE = "seldon.io/grpc-max-message-size"
DEFAULT_MAX_MSG_BYTES = 4 * 1024 * 1024
MAX_WORKERS = 8

_SERVICE_PACKAGE = "seldon.protos"


def _abort(context: grpc.ServicerContext, e: Exception):
    """The JAX package's status mapping: a shed is RESOURCE_EXHAUSTED,
    another 503 UNAVAILABLE, a 501 UNIMPLEMENTED, other 5xx INTERNAL, 4xx
    INVALID_ARGUMENT."""
    if isinstance(e, SeldonError):
        if e.status_code == 504 or e.reason == "DEADLINE_EXCEEDED":
            code = grpc.StatusCode.DEADLINE_EXCEEDED
        elif e.reason == "RESOURCE_EXHAUSTED":
            code = grpc.StatusCode.RESOURCE_EXHAUSTED
        elif e.status_code == 503:
            code = grpc.StatusCode.UNAVAILABLE
        elif e.status_code == 501:
            code = grpc.StatusCode.UNIMPLEMENTED
        elif e.status_code < 500:
            code = grpc.StatusCode.INVALID_ARGUMENT
        else:
            code = grpc.StatusCode.INTERNAL
        context.abort(code, e.message)
    logger.exception("grpc handler error")
    context.abort(grpc.StatusCode.INTERNAL, str(e))


def _metadata_value(context: grpc.ServicerContext, name: str) -> Optional[str]:
    """One invocation-metadata value by (lowercase) key, or None."""
    for key, value in context.invocation_metadata() or ():
        if key == name:
            return value
    return None


def _traceparent_from_context(context: grpc.ServicerContext) -> Optional[str]:
    """The inbound W3C ``traceparent`` metadata key, or None."""
    return _metadata_value(context, "traceparent")


def _deadline_s(context: grpc.ServicerContext) -> Optional[float]:
    """The client's gRPC deadline in seconds (``context.time_remaining()``),
    else the ``seldon-deadline-ms`` metadata key, else None (the JAX
    package's ``_deadline_from_context``)."""
    try:
        rem = context.time_remaining()
    except Exception:  # noqa: BLE001 — no deadline support on this context
        rem = None
    if rem is not None and rem < 1e9:  # grpc reports a huge value for "none"
        return rem
    raw = _metadata_value(context, DEADLINE_GRPC_METADATA)
    try:
        ms = float(raw) if raw is not None else 0.0
    except ValueError:
        return None
    return ms / 1000.0 if ms > 0 else None


def _deadline(context: grpc.ServicerContext) -> Optional[Deadline]:
    secs = _deadline_s(context)
    return Deadline(secs) if secs is not None else None


def _component_methods(component: Any) -> Dict[str, Dict[str, tuple]]:
    """service -> rpc name -> (handler, request class[, kind])."""

    tracer = get_tracer()

    def wrap(fn: Callable, req_from: Callable, method_name: str) -> Callable:
        def handler(request, context):
            try:
                with tracer.span("grpc:" + method_name,
                                 traceparent=_traceparent_from_context(context)):
                    out = dispatch.resolve(fn(component, req_from(request)))
                return pc.message_to_proto(out)
            except Exception as e:  # noqa: BLE001 — the request boundary
                _abort(context, e)
        return handler

    def debug_timeline(request, context):
        """REST ``/debug/timeline``'s payload as jsonData."""
        try:
            msg = pc.message_from_proto(request)
            body = msg.json_data if msg.which == "jsonData" else None
            n = parse_n(body.get("n") if isinstance(body, dict) else None)
            return pc.message_to_proto(
                SeldonMessage.from_json_data(timeline_report(component, n=n)))
        except Exception as e:  # noqa: BLE001 — the request boundary
            _abort(context, e)

    # single-prompt continuous batching lives in dispatch.predict itself
    predict = wrap(dispatch.predict, pc.message_from_proto, "predict")
    tin = wrap(dispatch.transform_input, pc.message_from_proto, "transform_input")
    tout = wrap(dispatch.transform_output, pc.message_from_proto, "transform_output")
    route = wrap(dispatch.route, pc.message_from_proto, "route")
    aggregate = wrap(dispatch.aggregate, pc.list_from_proto, "aggregate")
    fb = wrap(dispatch.send_feedback, pc.feedback_from_proto, "send_feedback")
    gen_stream = _make_generate_stream(component)
    return {
        "Model": {"Predict": (predict, pb.SeldonMessage), "SendFeedback": (fb, pb.Feedback),
                  "GenerateStream": (gen_stream, pb.SeldonMessage, "unary_stream"),
                  "DebugTimeline": (debug_timeline, pb.SeldonMessage)},
        "Generic": {
            "TransformInput": (tin, pb.SeldonMessage),
            "TransformOutput": (tout, pb.SeldonMessage),
            "Route": (route, pb.SeldonMessage),
            "Aggregate": (aggregate, pb.SeldonMessageList),
            "SendFeedback": (fb, pb.Feedback),
        },
        "Router": {"Route": (route, pb.SeldonMessage), "SendFeedback": (fb, pb.Feedback)},
        "Transformer": {"TransformInput": (tin, pb.SeldonMessage)},
        "OutputTransformer": {"TransformOutput": (tout, pb.SeldonMessage)},
        "Combiner": {"Aggregate": (aggregate, pb.SeldonMessageList)},
    }


def _make_generate_stream(component: Any):
    """Server-streaming generation, the JAX package's
    ``_make_generate_stream``: request jsonData ``{"prompt": str|[ids],
    "max_new_tokens": N, "seed": S}``; responses one jsonData event each,
    the SSE events of ``streaming.stream_events``. A client that cancels closes
    the generator, which cancels the request. With tracing on, the
    ``traceparent`` metadata roots the request's trace, whose id goes out in
    the initial metadata (``x-trace-id``, before the first token: trailing
    metadata never reaches a cancelled call) and in the done event."""

    def generate_stream(request, context):
        if not hasattr(component, "generate"):
            context.abort(grpc.StatusCode.UNIMPLEMENTED, "component has no generate() surface")
        try:
            msg = pc.message_from_proto(request)
            body = msg.json_data if msg.which == "jsonData" else None
            if not isinstance(body, dict) or body.get("prompt") is None:
                raise SeldonError("jsonData needs 'prompt'", status_code=400)
            # REST's rules on the metadata spellings of its headers
            identity = check_identity(body, _metadata_value(context, "seldon-tenant"),
                                      _metadata_value(context, "seldon-slo-class"),
                                      _deadline_s(context))
            prompt = body["prompt"]
            if isinstance(prompt, list):  # protobuf carries numbers as floats
                prompt = [int(t) for t in prompt]
            max_new = body.get("max_new_tokens")
            if max_new is not None:
                max_new = int(max_new)
            svc = stream_service(component, dict(body, prompt=prompt, max_new_tokens=max_new),
                                 knob="streaming")
            trace = ingress_trace(get_tracer(), _traceparent_from_context(context),
                                  "grpc:GenerateStream")
            events = stream_events(component, prompt, max_new, seed=body.get("seed"), svc=svc,
                                   identity=identity, trace=trace)
        except Exception as e:  # noqa: BLE001 — pre-stream rejection
            _abort(context, e)
        if trace is not None:
            context.send_initial_metadata(((TRACE_ID_HEADER.lower(), trace.trace_id),))
        try:
            for burst in events:
                for event in burst:
                    yield pc.message_to_proto(SeldonMessage.from_json_data(event))
        except Exception as e:  # noqa: BLE001
            _abort(context, e)
        finally:
            # a client that went away unwinds this generator with
            # GeneratorExit: closing the events cancels its request
            events.close()

    return generate_stream


def _generic_handlers(method_table: Dict[str, Dict[str, tuple]]):
    handlers = []
    for service, methods in method_table.items():
        rpc_handlers = {}
        for rpc_name, entry in methods.items():
            fn, req_cls = entry[0], entry[1]
            kind = entry[2] if len(entry) > 2 else "unary_unary"
            make = (grpc.unary_stream_rpc_method_handler if kind == "unary_stream"
                    else grpc.unary_unary_rpc_method_handler)
            rpc_handlers[rpc_name] = make(fn, request_deserializer=req_cls.FromString,
                                          response_serializer=lambda m: m.SerializeToString())
        handlers.append(grpc.method_handlers_generic_handler(f"{_SERVICE_PACKAGE}.{service}",
                                                             rpc_handlers))
    return handlers


def _server_options(annotations: Optional[Dict[str, str]]) -> list:
    max_size = DEFAULT_MAX_MSG_BYTES
    if annotations and ANNOTATION_GRPC_MAX_MSG_SIZE in annotations:
        max_size = int(annotations[ANNOTATION_GRPC_MAX_MSG_SIZE])
    return [("grpc.max_send_message_length", max_size),
            ("grpc.max_receive_message_length", max_size)]


def make_component_server(component: Any, port: Optional[int] = 5000, host: str = "0.0.0.0",
                          annotations: Optional[Dict[str, str]] = None) -> grpc.Server:
    """A gRPC server for ``component`` (not started); ``port=None`` binds
    nothing (add a port, then ``start``). ``annotations``: the pod's, of
    which ``seldon.io/grpc-max-message-size`` is read."""
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=MAX_WORKERS),
                         options=_server_options(annotations))
    for h in _generic_handlers(_component_methods(component)):
        server.add_generic_rpc_handlers((h,))
    if port is not None:
        server.add_insecure_port(f"{host}:{port}")
    return server


def serve_component(component: Any, host: str = "0.0.0.0", port: int = 5000,
                    annotations: Optional[Dict[str, str]] = None) -> None:
    """Serve ``component`` over gRPC until terminated."""
    server = make_component_server(component, port=port, host=host, annotations=annotations)
    server.start()
    logger.info("gRPC component server on %s:%d", host, port)
    server.wait_for_termination()


def make_engine_server(engine: Any, port: Optional[int] = 5001, host: str = "0.0.0.0",
                       metrics: Optional[MetricsRegistry] = None,
                       annotations: Optional[Dict[str, str]] = None,
                       admission: Optional[AdmissionController] = None) -> grpc.Server:
    """The Seldon external service over ``engine`` (not started; ``port=None``
    binds nothing). ``admission`` bounds concurrent predictions (overflow
    aborts RESOURCE_EXHAUSTED); by default from the annotations and env,
    off unless configured."""
    metrics = metrics or MetricsRegistry()
    admission = admission or AdmissionController.from_annotations(annotations)

    def predict(request, context):
        t0 = time.perf_counter()
        try:
            admission.acquire_sync()
        except ShedError as e:
            _abort(context, e)
        try:
            msg = pc.message_from_proto(request)
            with deadline_scope(_deadline(context)):
                with get_tracer().span("grpc:predictions",
                                       traceparent=_traceparent_from_context(context)):
                    out = engine.predict_sync(msg)
            metrics.observe_prediction(engine, out, time.perf_counter() - t0)
            return pc.message_to_proto(out)
        except Exception as e:  # noqa: BLE001 — the request boundary
            if getattr(e, "status_code", None) == 504:
                metrics.observe_deadline_exceeded("grpc")
            _abort(context, e)
        finally:
            admission.release()

    def send_feedback(request, context):
        try:
            fb = pc.feedback_from_proto(request)
            out = engine.send_feedback_sync(fb)
            metrics.observe_feedback(fb)
            return pc.message_to_proto(out)
        except Exception as e:  # noqa: BLE001 — the request boundary
            _abort(context, e)

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=MAX_WORKERS),
                         options=_server_options(annotations))
    for h in _generic_handlers({"Seldon": {"Predict": (predict, pb.SeldonMessage),
                                           "SendFeedback": (send_feedback, pb.Feedback)}}):
        server.add_generic_rpc_handlers((h,))
    if port is not None:
        server.add_insecure_port(f"{host}:{port}")
    return server


def serve_engine(engine: Any, host: str = "0.0.0.0", port: int = 5001,
                 metrics: Optional[MetricsRegistry] = None,
                 annotations: Optional[Dict[str, str]] = None) -> None:
    """Serve ``engine`` over gRPC until terminated."""
    server = make_engine_server(engine, port=port, host=host, metrics=metrics,
                                annotations=annotations)
    server.start()
    logger.info("gRPC engine server on %s:%d", host, port)
    server.wait_for_termination()


__all__ = ["ANNOTATION_GRPC_MAX_MSG_SIZE", "make_component_server", "make_engine_server",
           "serve_component", "serve_engine"]
