"""Request logger service of the port, ported from
``seldon_core_tpu/observability/request_logger.py`` (the reference's
`seldon-request-logger/app/app.py:15-60`): a small HTTP service that
receives the engine's CloudEvents request/response pairs (``CE-Type:
seldon.message.pair`` headers, `PredictionService.java:162-191`) and
flattens each batch element into one JSON line on its output stream for a
log pipeline. The lines are the JAX package's, key for key, for the same
posted pair.

The JAX package serves it on aiohttp; here ``make_logger_app`` returns a
request-handler class for the standard library's threading HTTP server,
as the port's REST apps do (``transport/rest.serve`` / ``start``). The
port's engine app posts its pairs here when ``REQUEST_LOGGER_URL`` is set
(``transport/rest.py``).
"""

from __future__ import annotations

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional


def _rows(data: Optional[Dict[str, Any]]) -> List[Any]:
    """Per-element rows from a SeldonMessage dict: one row per batch entry of
    ndarray/tensor data, else the scalar payload."""
    if not data:
        return [None]
    d = data.get("data", {})
    if "ndarray" in d:
        arr = d["ndarray"]
        return list(arr) if isinstance(arr, list) else [arr]
    if "tensor" in d:
        shape = d["tensor"].get("shape", [])
        values = d["tensor"].get("values", [])
        if len(shape) == 2 and shape[0] * shape[1] == len(values):
            n = shape[0]
            w = shape[1]
            return [values[i * w : (i + 1) * w] for i in range(n)]
        return [values]
    for key in ("strData", "binData", "jsonData"):
        if key in data:
            return [data[key]]
    return [None]


def flatten_pair(body: Dict[str, Any], ce_headers: Dict[str, str]) -> List[Dict[str, Any]]:
    """One log record per request row, paired positionally with response rows
    (the reference's per-element flattening)."""
    request = body.get("request", {})
    response = body.get("response", {})
    puid = (
        request.get("meta", {}).get("puid")
        or response.get("meta", {}).get("puid")
        or ce_headers.get("ce-requestid", "")
    )
    req_rows = _rows(request)
    resp_rows = _rows(response)
    n = max(len(req_rows), len(resp_rows))
    out = []
    for i in range(n):
        out.append(
            {
                "request.id": puid,
                "request.elem": i,
                "request.data": req_rows[i] if i < len(req_rows) else None,
                "response.data": resp_rows[i] if i < len(resp_rows) else None,
                "ce-type": ce_headers.get("ce-type", ""),
                "ce-source": ce_headers.get("ce-source", ""),
                "sdep": ce_headers.get("ce-sdep", ""),
            }
        )
    return out


def make_logger_app(out=None):
    """The request-handler class of the logger: POST ``/`` or ``/api/log``
    (one pair; 400 ``{"error": "bad json"}`` on a body that is not JSON),
    GET ``/ready`` and ``/live``. Records go to ``out`` (stdout by default),
    one JSON line each, a pair's lines together."""
    out = out or sys.stdout
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # no access log on stderr
            pass

        def _json(self, code: int, payload: Dict[str, Any]) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b""
            if self.path.split("?")[0] not in ("/", "/api/log"):
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                body = json.loads(raw)
            except ValueError:
                self._json(400, {"error": "bad json"})
                return
            ce = {k.lower(): v for k, v in self.headers.items() if k.lower().startswith("ce-")}
            lines = "".join(json.dumps(r) + "\n" for r in flatten_pair(body, ce))
            with lock:
                out.write(lines)
                out.flush()
            self._json(200, {"status": "ok"})

        def do_GET(self):
            if self.path.split("?")[0] in ("/ready", "/live"):
                self._json(200, {"status": "ok"})
            else:
                self._json(404, {"error": f"no route {self.path}"})

    return Handler


__all__ = ["flatten_pair", "make_logger_app"]
