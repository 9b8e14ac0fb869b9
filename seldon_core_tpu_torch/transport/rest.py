"""REST transport of the port, on the standard library's
``http.server.ThreadingHTTPServer`` (the card's machine has no aiohttp).
Two apps, as in ``seldon_core_tpu/transport/rest.py``.

**The component app** (``make_component_app``) serves one component:
``/ready``, ``/live`` and ``/health/status``; the scrape routes ``/metrics``
and ``/prometheus`` (``metrics/registry.py``, the LLM series synced from
``LLMServer.llm_stats`` at each scrape) and ``/seldon.json``
(``transport/openapi.wrapper_spec``); the method routes (GET and POST)
``/predict`` and ``/api/v0.1/predictions``, ``/transform-input``,
``/transform-output``, ``/route``, ``/aggregate`` (a SeldonMessageList),
``/send-feedback`` and ``/api/v0.1/feedback`` (a Feedback) — the body in,
through ``components/dispatch``, a SeldonMessage out, with the JAX
package's body forms (raw JSON, form field ``json=``, query ``?json=``,
multipart parts) and its ``{"status": ...}`` error payload; and ``POST
/v1/generate`` with the JSON request and response schema of the JAX
package:

    {"prompt": str|[ids], "max_new_tokens": N, "seed": S}
        one prompt; with the component's ``continuous_batching`` on it joins
        the shared decode batch (runtime/batcher.py) -> {"tokens", "text"}
        (+ "truncated_prompt" when the slot cache cut the prompt)
    {"prompt": ..., "stream": true}
        Server-Sent Events as the batch decodes: one ``data: {"token",
        "text"}`` event per token ("text" the decoded piece), then ``data:
        {"done": true, "tokens", "text"}`` (+ "truncated_prompt"); an error
        after the headers went out is one ``data: {"error": ...}`` event. On
        a replica fleet whose replica died mid-stream, one ``data:
        {"resumed": true, "tokens_delivered": n}`` event marks where a
        survivor took over (never a token).
        Chunked framing, one chunk per event, the events a drain surfaced
        together in one write; Nagle off. A component
        without ``continuous_batching`` streams through one shared 1-slot
        service (``runtime/batcher.ensure_stream_service``). A client that
        disconnects cancels its request; the batch serves on.
    {"prompts": [...], "max_new_tokens": N, "temperature": T, "seed": S}
        an explicit batch, served by one private generate() ->
        {"tokens": [[...]], "texts": [...]} (``"stream"`` is ignored here,
        as in the JAX package)

A per-request ``temperature`` takes the private generate() path (the batch
decodes every slot at the server's temperature), as does a seeded prompt
the slot cache cannot hold whole; a stream has no such path, so both answer
400 there. A page-exhaustion shed, and a fleet recovery refused by a
spent retry budget, answer 503 with a ``Retry-After`` header.

Tenant and SLO class ride the ``Seldon-Tenant`` / ``Seldon-SLO-Class``
headers, or the body fields ``tenant`` / ``slo_class`` (the body wins), as
in the JAX package, and reach the batcher's weighted-fair admission with
the body's ``adapter`` and a ``Seldon-Deadline-Ms`` budget. An unknown
class answers 400 on every branch; a tenant over its quota 503 with a
``Retry-After`` header. The framed binary wire answers 501; multipart
predict bodies answer 415.

Tracing (``tracing/``, on with ``TRACING=1``): ``/v1/generate`` takes the
inbound W3C ``traceparent`` (or starts a trace) as its ingress and hands it
to the batcher, whose flight recorder roots the request's timeline and span
tree there; the JSON answer carries ``trace_id``, a stream the
``X-Trace-Id`` header (before its first event) and ``trace_id`` in its
done event. The method routes and the engine's predictions open their
server span from the inbound ``traceparent``. ``GET /debug/timeline?n=K``
(both apps; the engine app's by component name) serves the recorder's
recent timelines and the scaling snapshot (``observability/timeline.py``),
and the scrape carries the tracer's export series.

The method routes pass the JAX app's admission gate
(``runtime/resilience.AdmissionController``, from the annotations and env by
default, off unless configured): past ``max_inflight`` calls and
``max_queue`` waiters a call answers 503 with a ``Retry-After`` from the
component's batcher backlog (``wire_retry_after``), and the scrape carries
the ``seldon_resilience_*`` admission series.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from seldon_core_tpu_torch.components import dispatch
from seldon_core_tpu_torch.contracts.payload import (Feedback, SeldonError, SeldonMessage,
                                                     SeldonMessageList, Status)
from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.metrics.registry import CONTENT_TYPE as PROM_CONTENT_TYPE
from seldon_core_tpu_torch.metrics.registry import MetricsRegistry
from seldon_core_tpu_torch.observability.timeline import parse_n, timeline_report
from seldon_core_tpu_torch.runtime.resilience import (DEADLINE_HEADER, AdmissionController,
                                                      Deadline, ShedError, current_deadline,
                                                      deadline_scope, wire_retry_after)
from seldon_core_tpu_torch.tracing import get_tracer, ingress_trace
from seldon_core_tpu_torch.transport.streaming import (TRACE_ID_HEADER, check_identity,
                                                       stream_events, stream_service)

logger = logging.getLogger(__name__)


def deadline_from_headers(headers: Mapping[str, str]) -> Optional[float]:
    """``Seldon-Deadline-Ms: <float>``, the client's budget for the request,
    in seconds; missing, garbage or non-positive means no deadline (the
    JAX package's ``deadline_from_headers``)."""
    raw = headers.get(DEADLINE_HEADER)
    if raw is None:
        return None
    try:
        ms = float(raw)
    except (TypeError, ValueError):
        return None
    return ms / 1000.0 if ms > 0 else None


def _generate(component: Any, body: Any, headers: Optional[Mapping[str, str]] = None,
              trace: Any = None):
    """The /v1/generate handler body (``headers``: the request's, read
    case-insensitively; ``trace``: its ingress ``TraceContext`` or None):
    returns the JSON response, or for ``"stream": true`` the generator of
    its events (``stream_events``, not started), or raises SeldonError
    (ShedError for a 503). The JAX package's rules:
    tenant and class from the body or the ``Seldon-Tenant`` /
    ``Seldon-SLO-Class`` headers (an unknown class is 400 on every branch);
    an ``"adapter"`` serves only through a batcher (the shared batch, else
    the 1-slot stream service), so with ``"prompts"``, with a per-request
    temperature, or as a seeded prompt the slot cache cannot hold it is 400;
    a tenant over its quota is 503 + Retry-After. A single prompt's answer
    carries ``trace_id`` when there is a trace."""
    from seldon_core_tpu_torch.runtime.batcher import ensure_stream_service, get_batcher_service

    if not isinstance(body, dict):
        raise SeldonError("body must be a JSON object", status_code=400)
    headers = headers or {}
    identity = check_identity(body, headers.get("Seldon-Tenant"),
                              headers.get("Seldon-SLO-Class"), deadline_from_headers(headers))
    adapter = identity["adapter"]
    max_new = body.get("max_new_tokens")
    if "prompts" in body:
        if adapter:
            raise SeldonError("adapters serve through the continuous batch; use single-prompt "
                              "requests (the 'prompts' batch runs a private base-model "
                              "generate())", status_code=400)
        return component.generate(body["prompts"], max_new_tokens=max_new,
                                  temperature=body.get("temperature"),
                                  seed=body.get("seed"))
    prompt = body.get("prompt")
    if prompt is None:
        raise SeldonError("body needs 'prompt' or 'prompts'", status_code=400)
    custom_sampling = "temperature" in body
    if adapter and custom_sampling:
        raise SeldonError("per-request temperature cannot join the shared batch, and adapters "
                          "only serve through it — drop one", status_code=400)
    svc = None if custom_sampling else get_batcher_service(component)
    if svc is None and adapter:
        svc = ensure_stream_service(component)
    if svc is not None and "seed" in body and not svc.batcher.accommodates(prompt, max_new):
        if adapter:
            raise SeldonError("seeded adapted prompt exceeds the batcher slot cache and would "
                              "not reproduce; raise continuous_batching_max_len",
                              status_code=400)
        svc = None  # only a per-request-sized generate() reproduces it
    if body.get("stream"):
        svc = stream_service(component, body, svc)
        return stream_events(component, prompt, max_new, seed=body.get("seed"), svc=svc,
                             identity=identity, trace=trace)
    if svc is None:
        out = component.generate([prompt], max_new_tokens=max_new,
                                 temperature=body.get("temperature"), seed=body.get("seed"))
        answer = {"tokens": out["tokens"][0], "text": out["texts"][0]}
        if trace is not None:
            # no recorder ran, but the client still gets its correlation id
            answer["trace_id"] = trace.trace_id
        return answer
    info: dict = {}
    if trace is not None:
        identity["trace"] = trace
    toks = svc.submit_sync(prompt, max_new, seed=body.get("seed"), info=info, **identity)
    tok = getattr(component, "_tokenizer", None)
    out = {"tokens": toks,
           "text": tok.decode(toks) if tok is not None and isinstance(prompt, str) else None}
    if trace is not None:
        out["trace_id"] = trace.trace_id
    if info.get("truncated_prompt"):
        out["truncated_prompt"] = info["truncated_prompt"]
    return out


PREDICT_ROUTES = ("/predict", "/api/v0.1/predictions")
CONTENT_TYPE_FRAME = "application/x-seldon-frame"


def _multipart(content_type: str, body: bytes) -> dict:
    """A multipart body's parts as the JAX package reads them: a file
    part's bytes (``binData`` base64-encoded, ``strData`` decoded, any
    other part JSON), a plain field's text (``strData`` as is, any other
    JSON)."""
    from email.parser import BytesParser
    from email.policy import HTTP

    msg = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1") + b"\r\n\r\n" + body)
    out: dict = {}
    for part in msg.iter_parts() if msg.is_multipart() else ():
        key = part.get_param("name", header="content-disposition")
        if key is None:  # aiohttp's error, a 500 in the JAX package too
            raise ValueError("Multipart field missing name.")
        raw = part.get_payload(decode=True) or b""
        if part.get_filename() is not None:
            if key == "binData":
                out[key] = base64.b64encode(raw).decode()
            elif key == "strData":
                out[key] = raw.decode()
            else:
                out[key] = _json_loads(raw.decode("utf-8", errors="replace"))
        else:
            text = raw.decode(part.get_content_charset() or "utf-8", errors="replace")
            out[key] = text if key == "strData" else _json_loads(text)
    return out


def parse_request(content_type: str, body: bytes, query: str) -> Any:
    """A request's JSON: the raw body, a form field ``json=``, multipart
    parts, or the query's ``?json=`` (the JAX package's
    ``parse_request``)."""
    ctype = (content_type or "").split(";")[0].strip().lower()
    if ctype.startswith("multipart/"):
        return _multipart(content_type, body)
    if ctype == CONTENT_TYPE_FRAME:
        raise SeldonError("the framed binary wire (application/x-seldon-frame) arrives with "
                          "the native-edge slice of the port; send JSON", status_code=501)
    text = body.decode("utf-8", errors="replace")
    if ctype == "application/x-www-form-urlencoded" and text:
        qs = parse_qs(text)
        if "json" in qs:
            return _json_loads(qs["json"][0])
        # fall through: clients (curl -d) often send raw JSON under the
        # default form content type
    if text:
        return _json_loads(text)
    qs = parse_qs(query)
    if "json" in qs:
        return _json_loads(qs["json"][0])
    raise SeldonError("Empty request body")


def _json_loads(text: str) -> Any:
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        raise SeldonError(f"Invalid JSON body: {e}")


def _error(e: Exception) -> Tuple[int, dict, dict]:
    if isinstance(e, SeldonError):
        headers = {}
        if isinstance(e, ShedError):
            headers["Retry-After"] = str(max(int(e.retry_after_s), 1))
        return e.status_code, {"status": e.to_status().to_dict()}, headers
    logger.exception("unhandled error")
    status = Status(code=500, info=str(e), reason="INTERNAL_ERROR", status="FAILURE")
    return 500, {"status": status.to_dict()}, {}


class _Handler(BaseHTTPRequestHandler):
    """What both apps' handlers share: the JSON and text answers, the
    error payload and the request counter (``metrics``, set per app)."""

    protocol_version = "HTTP/1.1"
    # small SSE writes must not wait for the client's delayed ACK
    disable_nagle_algorithm = True
    metrics: MetricsRegistry

    def log_message(self, fmt, *args):  # route access logs to logging
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _send(self, code: int, payload: Any, headers: Optional[dict] = None,
              content_type: str = "application/json"):
        data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _send_text(self, code: int, text: str):
        self._send(code, text.encode(), content_type="text/plain; charset=utf-8")

    def _send_error(self, e: Exception, method: str, t0: float):
        code, payload, headers = _error(e)
        self.metrics.observe_api_call(method, str(code), time.perf_counter() - t0)
        self._send(code, payload, headers)

    def _not_found(self, path: str):
        self._send(404, {"status": Status(404, f"no route {path}", "NOT_FOUND",
                                          "FAILURE").to_dict()})

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""


def make_component_app(component: Any, device: Optional[str] = None,
                       admission: Optional[AdmissionController] = None,
                       annotations: Optional[dict] = None):
    """The request-handler class serving ``component`` (pass it to
    ``serve`` or ``start``). ``device`` (default "cuda") is the device this
    server is meant to run on: it must resolve (no card raises) and match
    the component's, so a serving process never lands on the CPU unasked.
    Its registry (``Handler.metrics``) counts each
    method and generate request by code and latency. ``admission`` bounds
    the concurrent method calls (predict, transform, route, aggregate,
    feedback; overflow sheds 503 + Retry-After, the component's batcher
    backlog hint through ``wire_retry_after``); by default it comes from the
    annotations and env (``AdmissionController.from_annotations``), off
    unless configured. ``/v1/generate`` is not gated, as in the JAX app."""
    from seldon_core_tpu_torch.transport.openapi import wrapper_spec

    dev = resolve_device(device)
    comp_dev = getattr(component, "device", dev)
    if comp_dev != dev:
        raise ValueError(f"REST app device {dev} != component device {comp_dev}")
    registry = MetricsRegistry()
    admission = admission or AdmissionController.from_annotations(annotations)
    wire_retry_after(admission, component)
    tracer = get_tracer()

    msg, lst, fbk = SeldonMessage.from_dict, SeldonMessageList.from_dict, Feedback.from_dict
    routes: Dict[str, Tuple[Callable, Callable, str]] = {
        "/predict": (dispatch.predict, msg, "predict"),
        "/api/v0.1/predictions": (dispatch.predict, msg, "predict"),
        "/transform-input": (dispatch.transform_input, msg, "transform_input"),
        "/transform-output": (dispatch.transform_output, msg, "transform_output"),
        "/route": (dispatch.route, msg, "route"),
        "/aggregate": (dispatch.aggregate, lst, "aggregate"),
        "/send-feedback": (dispatch.send_feedback, fbk, "send_feedback"),
        "/api/v0.1/feedback": (dispatch.send_feedback, fbk, "send_feedback"),
    }

    class Handler(_Handler):
        metrics = registry

        def _method(self, route, raw: bytes, query: str):
            fn, parser, name = route
            t0 = time.perf_counter()
            try:
                admission.acquire_sync()
            except ShedError as e:
                self._send_error(e, name, t0)
                return
            try:
                payload = parser(parse_request(self.headers.get("Content-Type", ""), raw, query))
                # the inbound traceparent roots this request's server span
                # in the caller's trace (its sampled flag honoured)
                with tracer.span(name, traceparent=self.headers.get("traceparent")):
                    out = dispatch.resolve(fn(component, payload))
            except Exception as e:  # the request boundary: answer, keep serving
                self._send_error(e, name, t0)
                return
            finally:
                admission.release()
            registry.observe_api_call(name, "200", time.perf_counter() - t0)
            self._send(200, out.to_dict())

        def _write_events(self, events):
            # one chunk an event (its size line, data and CRLF), a burst of
            # events in one write
            chunks = []
            for event in events:
                data = b"data: %s\n\n" % json.dumps(event).encode()
                chunks.append(b"%x\r\n%s\r\n" % (len(data), data))
            self.wfile.write(b"".join(chunks))

        def _stream(self, events: Iterator[List[dict]], t0: float, trace: Any = None):
            """Write ``events`` (bursts of them) as SSE, one chunk an event,
            a burst in one write; with a ``trace``, its id in the
            ``X-Trace-Id`` header, before the first token. A write to a
            client that went away cancels the request (closing the
            generator) and ends the handler; an error after the headers is
            one ``error`` event."""
            code = "200"
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                if trace is not None:
                    self.send_header(TRACE_ID_HEADER, trace.trace_id)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for burst in events:
                        self._write_events(burst)
                except (BrokenPipeError, ConnectionResetError):
                    raise
                except Exception as e:  # after the headers: an event, then the end
                    code = str(getattr(e, "status_code", 500))
                    self._write_events([{"error": str(e)}])
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                code = "500"  # the client went away mid-stream (the JAX package's label)
                self.close_connection = True
            finally:
                events.close()
                registry.observe_api_call("generate", code, time.perf_counter() - t0)

        def do_GET(self):
            url = urlsplit(self.path)
            if url.path in ("/ready", "/live", "/health/status"):
                self._send(200, {"status": "ok"})
            elif url.path in ("/metrics", "/prometheus"):
                registry.sync_resilience(admission=admission, transport="rest")
                registry.sync_llm(component)
                registry.sync_controlplane(component)
                registry.sync_tracing()
                self._send(200, registry.expose(), content_type=PROM_CONTENT_TYPE)
            elif url.path == "/seldon.json":
                self._send(200, wrapper_spec())
            elif url.path == "/debug/timeline":
                n = parse_n(parse_qs(url.query).get("n", [None])[0])
                self._send(200, timeline_report(component, n=n))
            elif url.path in routes:
                self._method(routes[url.path], b"", url.query)
            else:
                self._not_found(url.path)

        def do_POST(self):
            raw = self._body()
            url = urlsplit(self.path)
            if url.path in routes:
                self._method(routes[url.path], raw, url.query)
                return
            if url.path != "/v1/generate":
                self._not_found(url.path)
                return
            t0 = time.perf_counter()
            # the inbound traceparent (or a fresh trace) rides into the
            # batcher, which roots the request's span tree at this ingress
            trace = ingress_trace(tracer, self.headers.get("traceparent"), "rest:/v1/generate")
            try:
                try:
                    body = json.loads(raw or b"null")
                except json.JSONDecodeError as e:
                    raise SeldonError(f"Invalid JSON body: {e}", status_code=400)
                out = _generate(component, body, self.headers, trace)
            except Exception as e:  # the request boundary: answer, keep serving
                self._send_error(e, "generate", t0)
                return
            if isinstance(out, dict):
                registry.observe_api_call("generate", "200", time.perf_counter() - t0)
                self._send(200, out)
            else:
                self._stream(out, t0, trace)

    return Handler


def _post_to_logger(url: str, pair: dict) -> None:
    """POST one request/response pair to the request logger as a CloudEvent
    (the reference's `PredictionService.java:162-191`); a failure is
    logged, never raised."""
    headers = {"Content-Type": "application/json", "CE-Type": "seldon.message.pair",
               "CE-Source": "seldon-engine-tpu", "CE-SDep": os.environ.get("DEPLOYMENT_NAME", ""),
               "CE-RequestId": (pair["response"].get("meta") or {}).get("puid", "")}
    try:
        req = urllib.request.Request(url, data=json.dumps(pair).encode(), headers=headers)
        with urllib.request.urlopen(req, timeout=2) as r:
            r.read()
    except Exception as e:  # logging must never fail the request
        logger.warning("request-logger post failed: %s", e)


def make_engine_app(engine: Any, metrics: Optional[MetricsRegistry] = None,
                    admission: Optional[AdmissionController] = None,
                    annotations: Optional[dict] = None, device: Optional[str] = None):
    """The request-handler class serving ``engine`` (a
    ``runtime/engine.GraphEngine``; pass it to ``serve`` or ``start``).
    ``device`` (default "cuda") must resolve and match the engine's.
    ``admission`` bounds concurrent predictions (overflow sheds 503 +
    Retry-After); by default it comes from the annotations and env
    (``AdmissionController.from_annotations``), off unless configured. The
    handler thread drives the graph (``predict_sync``) inside the request's
    deadline scope. ``Handler.state`` holds the pause and ready flags."""
    from seldon_core_tpu_torch.transport.openapi import engine_spec

    dev = resolve_device(device)
    if engine.device != dev:
        raise ValueError(f"REST app device {dev} != engine device {engine.device}")
    registry = metrics or MetricsRegistry()
    admission = admission or AdmissionController.from_annotations(annotations)
    state = {"paused": False, "ready": True}
    log_requests = os.environ.get("SELDON_LOG_REQUESTS", "") == "1"
    log_responses = os.environ.get("SELDON_LOG_RESPONSES", "") == "1"
    logger_url = os.environ.get("REQUEST_LOGGER_URL", "")
    profile_lock = threading.Lock()
    tracer = get_tracer()

    def log_pair(req_dict: dict, resp_dict: dict) -> None:
        if log_requests:
            print(json.dumps({"request": req_dict}), flush=True)
        if log_responses:
            print(json.dumps({"response": resp_dict}), flush=True)
        if logger_url:
            threading.Thread(target=_post_to_logger, name="request-logger", daemon=True,
                             args=(logger_url, {"request": req_dict, "response": resp_dict})
                             ).start()

    class Handler(_Handler):
        metrics = registry

        def _predictions(self, raw: bytes, query: str):
            if state["paused"]:
                self._send(503, {"status": {"code": 503, "info": "paused", "status": "FAILURE"}})
                return
            t0 = time.perf_counter()
            try:
                # admission before parsing: a shed stays cheap under load
                admission.acquire_sync()
            except ShedError as e:
                self._send_error(e, "predictions", t0)
                return
            try:
                # the budget starts before the body is parsed, as in the JAX app
                secs = deadline_from_headers(self.headers)
                deadline = Deadline(secs) if secs is not None else None
                body = parse_request(self.headers.get("Content-Type", ""), raw, query)
                msg = SeldonMessage.from_dict(body)
                with deadline_scope(deadline):
                    # the graph's node spans (and a remote hop's traceparent)
                    # hang under this server span
                    with tracer.span("predictions", traceparent=self.headers.get("traceparent")):
                        out = engine.predict_sync(msg)
                    d = current_deadline()
                    if d is not None:
                        registry.observe_remaining_budget(d.remaining_s())
                registry.observe_prediction(engine, out, time.perf_counter() - t0)
                resp = out.to_dict()
                if log_requests or log_responses or logger_url:
                    log_pair(body, resp)
                self._send(200, resp)
            except Exception as e:  # the request boundary: answer, keep serving
                if getattr(e, "status_code", 500) == 504:
                    registry.observe_deadline_exceeded("rest")
                self._send_error(e, "predictions", t0)
            finally:
                admission.release()

        def _feedback(self, raw: bytes, query: str):
            t0 = time.perf_counter()
            try:
                body = parse_request(self.headers.get("Content-Type", ""), raw, query)
                fb = Feedback.from_dict(body)
                with tracer.span("feedback"):
                    out = engine.send_feedback_sync(fb)
                registry.observe_feedback(fb)
            except Exception as e:  # the request boundary: answer, keep serving
                self._send_error(e, "feedback", t0)
                return
            registry.observe_api_call("feedback", "200", time.perf_counter() - t0)
            self._send(200, out.to_dict())

        def _control(self, path: str) -> bool:
            """The routes both GET and POST reach; False for another path."""
            if path == "/pause":
                state["paused"] = True
                self._send_text(200, "paused")
            elif path == "/unpause":
                state["paused"] = False
                self._send_text(200, "unpaused")
            else:
                return False
            return True

        def do_GET(self):
            url = urlsplit(self.path)
            if self._control(url.path):
                return
            if url.path == "/ready":
                if state["ready"] and not state["paused"]:
                    self._send_text(200, "ready")
                else:
                    self._send_text(503, "not ready")
            elif url.path == "/live":
                self._send_text(200, "live")
            elif url.path == "/ping":
                self._send_text(200, "pong")
            elif url.path in ("/metrics", "/prometheus"):
                registry.sync_resilience(engine=engine, admission=admission, transport="rest")
                for comp in engine._components.values():
                    registry.sync_llm(comp)
                registry.sync_controlplane(engine)
                registry.sync_tracing()
                self._send(200, registry.expose(), content_type=PROM_CONTENT_TYPE)
            elif url.path == "/seldon.json":
                self._send(200, engine_spec())
            elif url.path == "/debug/timeline":
                # every in-process component's timelines and scaling snapshot
                n = parse_n(parse_qs(url.query).get("n", [None])[0])
                self._send(200, {name: timeline_report(comp, n=n)
                                 for name, comp in engine._components.items()})
            else:
                self._not_found(url.path)

        def do_POST(self):
            raw = self._body()
            url = urlsplit(self.path)
            if url.path in ("/api/v0.1/predictions", "/predict"):
                self._predictions(raw, url.query)
            elif url.path in ("/api/v0.1/feedback", "/send-feedback"):
                self._feedback(raw, url.query)
            elif url.path == "/profile":
                self._profile(url.query)
            elif not self._control(url.path):
                self._not_found(url.path)

        def _profile(self, query: str):
            """A ``torch.profiler`` trace (host, and the card's kernels on
            CUDA) of ``?seconds=N`` (default 2, at most 60) written under
            ``SELDON_PROFILE_DIR``; opt-in, one at a time."""
            base = os.environ.get("SELDON_PROFILE_DIR", "")
            if not base:
                self._send(403, {"status": {"code": 403,
                                            "info": "set SELDON_PROFILE_DIR to enable"}})
                return
            if not profile_lock.acquire(blocking=False):
                self._send(409, {"status": {"code": 409, "info": "profile already running"}})
                return
            try:
                try:
                    seconds = float(parse_qs(query).get("seconds", ["2"])[0])
                except ValueError:
                    seconds = 2.0
                if not (0 < seconds <= 60):  # also false for NaN
                    seconds = 2.0
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if engine.device.type == "cuda":
                    activities.append(ProfilerActivity.CUDA)
                out_dir = os.path.join(base, f"trace_{int(time.time())}")
                os.makedirs(out_dir, exist_ok=True)
                with profile(activities=activities) as prof:
                    time.sleep(seconds)
                prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
            finally:
                profile_lock.release()
            self._send(200, {"trace_dir": out_dir, "seconds": seconds})

    Handler.state = state
    return Handler


def serve(app, host: str = "0.0.0.0", port: int = 9000) -> None:
    """Serve ``app`` (from ``make_component_app`` or ``make_engine_app``)
    until interrupted."""
    with ThreadingHTTPServer((host, port), app) as httpd:
        logger.info("REST serving on %s:%d", host, httpd.server_address[1])
        httpd.serve_forever()


def start(app, host: str = "127.0.0.1", port: int = 0):
    """Serve ``app`` on a background thread; returns (httpd, thread). The
    bound port is ``httpd.server_address[1]``; stop with
    ``httpd.shutdown(); httpd.server_close()``."""
    httpd = ThreadingHTTPServer((host, port), app)
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever, name="rest-server", daemon=True)
    thread.start()
    return httpd, thread


__all__ = ["make_component_app", "make_engine_app", "parse_request", "serve", "start"]
