"""REST transport of the port, on the standard library's
``http.server.ThreadingHTTPServer`` (the card's machine has no aiohttp).

Port of two surfaces of ``seldon_core_tpu/transport/rest.py``: ``/ready``,
``/live`` and ``/health/status``; the one-model predict routes ``/predict``
and ``/api/v0.1/predictions`` (GET and POST) — a SeldonMessage in, through
``components/dispatch.predict``, a SeldonMessage out, with the JAX
package's body forms (raw JSON, form field ``json=``, query ``?json=``) and
its ``{"status": ...}`` error payload; and ``POST /v1/generate`` with the
JSON request and response schema of the JAX package, non-streaming:

    {"prompt": str|[ids], "max_new_tokens": N, "seed": S}
        one prompt; with the component's ``continuous_batching`` on it joins
        the shared decode batch (runtime/batcher.py) -> {"tokens", "text"}
        (+ "truncated_prompt" when the slot cache cut the prompt)
    {"prompts": [...], "max_new_tokens": N, "temperature": T, "seed": S}
        an explicit batch, served by one private generate() ->
        {"tokens": [[...]], "texts": [...]}

A per-request ``temperature`` takes the private generate() path (the batch
decodes every slot at the server's temperature), as does a seeded prompt
the slot cache cannot hold whole. A page-exhaustion shed answers 503 with a
``Retry-After`` header.

Tenant and SLO class ride the ``Seldon-Tenant`` / ``Seldon-SLO-Class``
headers, or the body fields ``tenant`` / ``slo_class`` (the body wins), as
in the JAX package. An unknown class answers 400 on every branch. The
port's FIFO admission serves the default class (``interactive``, or no
class); a tenant or another known class answers 501 naming the LoRA/tenants
slice, as do adapters. Streaming (SSE) answers 501 too, as do the framed
binary wire; multipart predict bodies answer 415.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Mapping, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from seldon_core_tpu_torch.components import dispatch
from seldon_core_tpu_torch.contracts.payload import SeldonError, SeldonMessage, Status
from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.runtime.resilience import ShedError
from seldon_core_tpu_torch.runtime.scheduler import INTERACTIVE, normalize_slo_class

logger = logging.getLogger(__name__)

_LATER = {
    "stream": "SSE streaming arrives with the streaming slice",
    "adapter": "adapters arrive with the LoRA/tenants slice",
    "tenant": "tenants arrive with the LoRA/tenants slice",
    "slo_class": "SLO classes other than 'interactive' arrive with the LoRA/tenants slice",
}


def _generate(component: Any, body: Any, headers: Optional[Mapping[str, str]] = None) -> dict:
    """The /v1/generate handler body (``headers``: the request's, read
    case-insensitively): returns the JSON response or raises SeldonError
    (ShedError for a 503)."""
    from seldon_core_tpu_torch.runtime.batcher import get_batcher_service

    if not isinstance(body, dict):
        raise SeldonError("body must be a JSON object", status_code=400)
    headers = headers or {}
    # the reference's precedence: the body field, then the header; a typo'd
    # class fails on every branch before anything is refused or served
    tenant = body.get("tenant") or headers.get("Seldon-Tenant")
    try:
        slo_class = normalize_slo_class(body.get("slo_class")
                                        or headers.get("Seldon-SLO-Class"))
    except ValueError as e:
        raise SeldonError(str(e), status_code=400)
    # FIFO admission serves the default class; anything else is refused
    knobs = dict(body, tenant=tenant, slo_class=slo_class != INTERACTIVE)
    for key, why in _LATER.items():
        if knobs.get(key):
            raise SeldonError(f"'{key}' is not served by this port yet: {why}",
                              status_code=501)
    max_new = body.get("max_new_tokens")
    if "prompts" in body:
        return component.generate(body["prompts"], max_new_tokens=max_new,
                                  temperature=body.get("temperature"),
                                  seed=body.get("seed"))
    prompt = body.get("prompt")
    if prompt is None:
        raise SeldonError("body needs 'prompt' or 'prompts'", status_code=400)
    svc = None if "temperature" in body else get_batcher_service(component)
    if svc is not None and "seed" in body and not svc.batcher.accommodates(prompt, max_new):
        svc = None  # only a per-request-sized generate() reproduces it
    if svc is None:
        out = component.generate([prompt], max_new_tokens=max_new,
                                 temperature=body.get("temperature"), seed=body.get("seed"))
        return {"tokens": out["tokens"][0], "text": out["texts"][0]}
    info: dict = {}
    toks = svc.submit_sync(prompt, max_new, seed=body.get("seed"), info=info)
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
    the component's, so a serving process never lands on the CPU unasked."""
    dev = resolve_device(device)
    comp_dev = getattr(component, "device", dev)
    if comp_dev != dev:
        raise ValueError(f"REST app device {dev} != component device {comp_dev}")

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route access logs to logging
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, code: int, payload: Any, headers: Optional[dict] = None):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _not_found(self, path: str):
            self._send(404, {"status": Status(404, f"no route {path}", "NOT_FOUND",
                                              "FAILURE").to_dict()})

        def _predict(self, raw: bytes, query: str):
            try:
                body = parse_request(self.headers.get("Content-Type", ""), raw, query)
                msg = dispatch.predict(component, SeldonMessage.from_dict(body))
                self._send(200, msg.to_dict())
            except Exception as e:  # the request boundary: answer, keep serving
                code, payload, headers = _error(e)
                self._send(code, payload, headers)

        def do_GET(self):
            url = urlsplit(self.path)
            if url.path in ("/ready", "/live", "/health/status"):
                self._send(200, {"status": "ok"})
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
            try:
                try:
                    body = json.loads(raw or b"null")
                except json.JSONDecodeError as e:
                    raise SeldonError(f"Invalid JSON body: {e}", status_code=400)
                self._send(200, _generate(component, body, self.headers))
            except Exception as e:  # the request boundary: answer, keep serving
                code, payload, headers = _error(e)
                self._send(code, payload, headers)

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
