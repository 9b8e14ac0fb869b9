"""REST transport of the port, on the standard library's
``http.server.ThreadingHTTPServer`` (the card's machine has no aiohttp).

Port of these surfaces of ``seldon_core_tpu/transport/rest.py``: ``/ready``,
``/live`` and ``/health/status``; the scrape routes ``/metrics`` and
``/prometheus`` (``metrics/registry.py``, the LLM series synced from
``LLMServer.llm_stats`` at each scrape) and ``/seldon.json``
(``transport/openapi.wrapper_spec``); the one-model predict routes
``/predict`` and ``/api/v0.1/predictions`` (GET and POST) — a SeldonMessage
in, through ``components/dispatch.predict``, a SeldonMessage out, with the
JAX package's body forms (raw JSON, form field ``json=``, query ``?json=``)
and its ``{"status": ...}`` error payload; and ``POST /v1/generate`` with the
JSON request and response schema of the JAX package:

    {"prompt": str|[ids], "max_new_tokens": N, "seed": S}
        one prompt; with the component's ``continuous_batching`` on it joins
        the shared decode batch (runtime/batcher.py) -> {"tokens", "text"}
        (+ "truncated_prompt" when the slot cache cut the prompt)
    {"prompt": ..., "stream": true}
        Server-Sent Events as the batch decodes: one ``data: {"token",
        "text"}`` event per token ("text" the decoded piece), then ``data:
        {"done": true, "tokens", "text"}`` (+ "truncated_prompt"); an error
        after the headers went out is one ``data: {"error": ...}`` event.
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
400 there. A page-exhaustion shed answers 503 with a ``Retry-After``
header.

Tenant and SLO class ride the ``Seldon-Tenant`` / ``Seldon-SLO-Class``
headers, or the body fields ``tenant`` / ``slo_class`` (the body wins), as
in the JAX package, and reach the batcher's weighted-fair admission with
the body's ``adapter`` and a ``Seldon-Deadline-Ms`` budget. An unknown
class answers 400 on every branch; a tenant over its quota 503 with a
``Retry-After`` header. The framed binary wire answers 501; multipart
predict bodies answer 415.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Iterator, List, Mapping, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from seldon_core_tpu_torch.components import dispatch
from seldon_core_tpu_torch.contracts.payload import SeldonError, SeldonMessage, Status
from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.metrics.registry import CONTENT_TYPE as PROM_CONTENT_TYPE
from seldon_core_tpu_torch.metrics.registry import MetricsRegistry
from seldon_core_tpu_torch.runtime.resilience import ShedError
from seldon_core_tpu_torch.transport.streaming import (check_identity, stream_events,
                                                       stream_service)

logger = logging.getLogger(__name__)


DEADLINE_HEADER = "Seldon-Deadline-Ms"


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


def _generate(component: Any, body: Any, headers: Optional[Mapping[str, str]] = None):
    """The /v1/generate handler body (``headers``: the request's, read
    case-insensitively): returns the JSON response, or for ``"stream":
    true`` the generator of its events (``stream_events``, not started),
    or raises SeldonError (ShedError for a 503). The JAX package's rules:
    tenant and class from the body or the ``Seldon-Tenant`` /
    ``Seldon-SLO-Class`` headers (an unknown class is 400 on every branch);
    an ``"adapter"`` serves only through a batcher (the shared batch, else
    the 1-slot stream service), so with ``"prompts"``, with a per-request
    temperature, or as a seeded prompt the slot cache cannot hold it is 400;
    a tenant over its quota is 503 + Retry-After."""
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
                             identity=identity)
    if svc is None:
        out = component.generate([prompt], max_new_tokens=max_new,
                                 temperature=body.get("temperature"), seed=body.get("seed"))
        return {"tokens": out["tokens"][0], "text": out["texts"][0]}
    info: dict = {}
    toks = svc.submit_sync(prompt, max_new, seed=body.get("seed"), info=info, **identity)
    tok = getattr(component, "_tokenizer", None)
    out = {"tokens": toks,
           "text": tok.decode(toks) if tok is not None and isinstance(prompt, str) else None}
    if info.get("truncated_prompt"):
        out["truncated_prompt"] = info["truncated_prompt"]
    return out


PREDICT_ROUTES = ("/predict", "/api/v0.1/predictions")
CONTENT_TYPE_FRAME = "application/x-seldon-frame"


def parse_request(content_type: str, body: bytes, query: str) -> Any:
    """A predict request's JSON: the raw body, a form field ``json=``, or
    the query's ``?json=`` (the JAX package's ``parse_request`` less
    multipart)."""
    ctype = (content_type or "").split(";")[0].strip().lower()
    if ctype.startswith("multipart/"):
        raise SeldonError("multipart predict bodies arrive with the engine slice of the port; "
                          "send JSON", status_code=415)
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


def make_component_app(component: Any, device: Optional[str] = None):
    """The request-handler class serving ``component`` (pass it to
    ``serve`` or ``start``). ``device`` (default "cuda") is the device this
    server is meant to run on: it must resolve (no card raises) and match
    the component's, so a serving process never lands on the CPU unasked.
    Its registry (``Handler.metrics``) counts each predict and generate
    request by code and latency."""
    from seldon_core_tpu_torch.transport.openapi import wrapper_spec

    dev = resolve_device(device)
    comp_dev = getattr(component, "device", dev)
    if comp_dev != dev:
        raise ValueError(f"REST app device {dev} != component device {comp_dev}")
    registry = MetricsRegistry()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # small SSE writes must not wait for the client's delayed ACK
        disable_nagle_algorithm = True
        metrics = registry

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

        def _send_error(self, e: Exception, method: str, t0: float):
            code, payload, headers = _error(e)
            registry.observe_api_call(method, str(code), time.perf_counter() - t0)
            self._send(code, payload, headers)

        def _not_found(self, path: str):
            self._send(404, {"status": Status(404, f"no route {path}", "NOT_FOUND",
                                              "FAILURE").to_dict()})

        def _predict(self, raw: bytes, query: str):
            t0 = time.perf_counter()
            try:
                body = parse_request(self.headers.get("Content-Type", ""), raw, query)
                msg = dispatch.predict(component, SeldonMessage.from_dict(body))
            except Exception as e:  # the request boundary: answer, keep serving
                self._send_error(e, "predict", t0)
                return
            registry.observe_api_call("predict", "200", time.perf_counter() - t0)
            self._send(200, msg.to_dict())

        def _write_events(self, events):
            # one chunk an event (its size line, data and CRLF), a burst of
            # events in one write
            chunks = []
            for event in events:
                data = b"data: %s\n\n" % json.dumps(event).encode()
                chunks.append(b"%x\r\n%s\r\n" % (len(data), data))
            self.wfile.write(b"".join(chunks))

        def _stream(self, events: Iterator[List[dict]], t0: float):
            """Write ``events`` (bursts of them) as SSE, one chunk an event,
            a burst in one write. A write to a client that went away
            cancels the request (closing the generator) and ends the
            handler; an error after the headers is one ``error`` event."""
            code = "200"
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
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
                registry.sync_llm(component)
                self._send(200, registry.expose(), content_type=PROM_CONTENT_TYPE)
            elif url.path == "/seldon.json":
                self._send(200, wrapper_spec())
            elif url.path in PREDICT_ROUTES:
                self._predict(b"", url.query)
            else:
                self._not_found(url.path)

        def do_POST(self):
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b""
            url = urlsplit(self.path)
            if url.path in PREDICT_ROUTES:
                self._predict(raw, url.query)
                return
            if url.path != "/v1/generate":
                self._not_found(url.path)
                return
            t0 = time.perf_counter()
            try:
                try:
                    body = json.loads(raw or b"null")
                except json.JSONDecodeError as e:
                    raise SeldonError(f"Invalid JSON body: {e}", status_code=400)
                out = _generate(component, body, self.headers)
            except Exception as e:  # the request boundary: answer, keep serving
                self._send_error(e, "generate", t0)
                return
            if isinstance(out, dict):
                registry.observe_api_call("generate", "200", time.perf_counter() - t0)
                self._send(200, out)
            else:
                self._stream(out, t0)

    return Handler


def serve(app, host: str = "0.0.0.0", port: int = 9000) -> None:
    """Serve ``app`` (from ``make_component_app``) until interrupted."""
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


__all__ = ["make_component_app", "parse_request", "serve", "start"]
