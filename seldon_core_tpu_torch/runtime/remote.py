"""Remote graph nodes of the port: ``seldon_core_tpu/runtime/remote.py``'s
``RemoteComponent``, a component in another process reached over REST or
gRPC.

The reference calls every node this way
(`engine/src/main/java/io/seldon/engine/service/InternalPredictionService.java:186-443`:
per-node REST/gRPC with 3 retries and timeouts from annotations). Here a
remote hop is a unit with an ``endpoint``; its semantics are the JAX
package's: the same routes and gRPC methods, the same payload JSON, retries
with backoff ``0.05 * 2**attempt``, each attempt clamped to the request's
remaining deadline (``effective_timeout``; a spent budget raises 504
before any network work), 503 ``REMOTE_NODE_UNAVAILABLE`` once the retries
run out, ``REMOTE_NODE_ERROR`` with the peer's status for a non-200 reply.

The REST hop runs the standard library's ``http.client`` in a worker thread
(``asyncio.to_thread``; the card's machine has no aiohttp), so the engine's
event-loop path still fans remote children out concurrently. Connections
are kept alive in a pool on the component (so they outlive the short event
loops of ``GraphEngine.predict_sync``) with ``TCP_NODELAY`` set: a hop is a
small request/response pair, and Nagle's buffering would add up to a round
trip of idle wait to each. The connect timeout bounds the connect; the hop
timeout bounds each socket operation after it.

The gRPC hop is ``transport/grpc_client.unary_call``. It is not retried,
as in the JAX package; its status maps to the same errors (UNAVAILABLE ->
503 ``REMOTE_NODE_UNAVAILABLE``, DEADLINE_EXCEEDED -> 504, another code ->
``REMOTE_NODE_ERROR``).

Only the JSON wire format is served: ``"frame"`` and ``"auto"`` (binary
frames, ``codec/framing.py``) raise ``NotImplementedError`` naming the
native-edge slice, as the port's REST app answers 501 to a framed body.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import logging
import socket
import threading
from typing import Any, List, Optional, Sequence

from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.graph import Endpoint, EndpointType
from seldon_core_tpu_torch.contracts.payload import (Feedback, SeldonError, SeldonMessage,
                                                     SeldonMessageList)
from seldon_core_tpu_torch.runtime.resilience import (DeadlineExceeded, current_deadline,
                                                      effective_timeout)
from seldon_core_tpu_torch.tracing import current_traceparent

logger = logging.getLogger(__name__)

DEFAULT_RETRIES = 3  # the reference's default (`InternalPredictionService.java:84`)
DEFAULT_TIMEOUT_S = 5.0
# no connect deadline of its own unless the annotation asks for one: the
# hop timeout already bounds a slow connect
DEFAULT_CONNECT_TIMEOUT_S = None

# the reference's per-deployment tuning annotations
# (`InternalPredictionService.java:82-91`, doc/source/graph/annotations.md)
ANNOTATION_REST_READ_TIMEOUT = "seldon.io/rest-read-timeout"              # ms
ANNOTATION_REST_CONNECTION_TIMEOUT = "seldon.io/rest-connection-timeout"  # ms
ANNOTATION_REST_RETRIES = "seldon.io/rest-connect-retries"
ANNOTATION_GRPC_READ_TIMEOUT = "seldon.io/grpc-read-timeout"              # ms
# the hop's wire format for tensor payloads: json (the default), frame or
# auto (binary frames; the native-edge slice)
ANNOTATION_WIRE_FORMAT = "seldon.io/wire-format"

WIRE_FORMATS = ("json", "frame", "auto")
FRAME_SLICE = "the native-edge slice of the port (ROADMAP Queue A item 12)"


def config_from_annotations(annotations: Optional[dict]) -> dict:
    """Remote-call tuning from deployment annotations; a missing or garbage
    value keeps its default (the reference parser's tolerance)."""
    annotations = annotations or {}

    def ms(key: str, default_s: Optional[float]) -> Optional[float]:
        try:
            return float(annotations[key]) / 1000.0
        except (KeyError, TypeError, ValueError):
            return default_s

    try:
        retries = int(annotations[ANNOTATION_REST_RETRIES])
    except (KeyError, TypeError, ValueError):
        retries = DEFAULT_RETRIES
    wire_format = str(annotations.get(ANNOTATION_WIRE_FORMAT, "json") or "json").strip().lower()
    if wire_format not in WIRE_FORMATS:
        wire_format = "json"
    return {
        "retries": max(retries, 1),
        "timeout_s": ms(ANNOTATION_REST_READ_TIMEOUT, DEFAULT_TIMEOUT_S),
        "connect_timeout_s": ms(ANNOTATION_REST_CONNECTION_TIMEOUT, DEFAULT_CONNECT_TIMEOUT_S),
        "grpc_timeout_s": ms(ANNOTATION_GRPC_READ_TIMEOUT, DEFAULT_TIMEOUT_S),
        "wire_format": wire_format,
    }


# a connection a peer closed between requests fails its next request
# before any reply: resent once on a fresh connection, within the attempt
_STALE = (http.client.RemoteDisconnected, BrokenPipeError, ConnectionResetError)


class _ConnectionPool:
    """Idle keep-alive connections to one peer, ``TCP_NODELAY`` on each."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self._idle: List[http.client.HTTPConnection] = []
        self._lock = threading.Lock()

    def take(self, connect_timeout_s: Optional[float]):
        """(connection, reused?)."""
        with self._lock:
            if self._idle:
                return self._idle.pop(), True
        conn = http.client.HTTPConnection(self.host, self.port, timeout=connect_timeout_s)
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return conn, False

    def give(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            self._idle.append(conn)

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            conn.close()


def _grpc_error(e: Exception, target: str) -> SeldonError:
    """A gRPC hop's failure as the JAX package's REST errors."""
    import grpc

    code = e.code() if isinstance(e, grpc.RpcError) else None
    detail = e.details() if isinstance(e, grpc.RpcError) else str(e)
    if code == grpc.StatusCode.DEADLINE_EXCEEDED:
        return DeadlineExceeded(f"deadline exceeded during remote hop to {target}: {detail}")
    if code == grpc.StatusCode.UNAVAILABLE:
        return SeldonError(f"Remote node {target} unreachable: {detail}", status_code=503,
                           reason="REMOTE_NODE_UNAVAILABLE")
    status = {grpc.StatusCode.INVALID_ARGUMENT: 400, grpc.StatusCode.UNIMPLEMENTED: 501,
              grpc.StatusCode.RESOURCE_EXHAUSTED: 503}.get(code, 500)
    return SeldonError(f"Remote node {target} returned {code}: {detail}", status_code=status,
                       reason="REMOTE_NODE_ERROR")


class RemoteComponent(SeldonComponent):
    """A graph node reached over the network. It implements the ``*_raw``
    contract, so dispatch passes whole messages through untouched."""

    is_async = True

    def __init__(self, endpoint: Endpoint, retries: int = DEFAULT_RETRIES,
                 timeout_s: Optional[float] = DEFAULT_TIMEOUT_S,
                 connect_timeout_s: Optional[float] = DEFAULT_CONNECT_TIMEOUT_S,
                 grpc_timeout_s: Optional[float] = None, annotations: Optional[dict] = None,
                 wire_format: str = "json"):
        super().__init__()
        self.endpoint = endpoint
        if annotations:
            cfg = config_from_annotations(annotations)
            retries = cfg["retries"]
            timeout_s = cfg["timeout_s"]
            connect_timeout_s = cfg["connect_timeout_s"]
            grpc_timeout_s = cfg["grpc_timeout_s"]
            if cfg["wire_format"] != "json":
                wire_format = cfg["wire_format"]
        if wire_format not in WIRE_FORMATS:
            raise ValueError(f"wire_format {wire_format!r}: expected one of {WIRE_FORMATS}")
        if wire_format != "json":
            raise NotImplementedError(f"remote hop wire_format {wire_format!r} (binary frames, "
                                      f"codec/framing.py) arrives with {FRAME_SLICE}; use "
                                      f"'json'")
        self.retries = retries
        self.timeout_s = timeout_s
        self.connect_timeout_s = connect_timeout_s
        self.grpc_timeout_s = grpc_timeout_s if grpc_timeout_s is not None else timeout_s
        self.wire_format = wire_format
        self._pool = _ConnectionPool(endpoint.service_host, int(endpoint.service_port))

    def load(self) -> None:
        pass

    @property
    def _target(self) -> str:
        return f"{self.endpoint.service_host}:{self.endpoint.service_port}"

    # -- transport ------------------------------------------------------
    def _post(self, path: str, body: bytes, headers: dict, hop_timeout: Optional[float]):
        """One POST on a pooled connection: (status, body text)."""
        conn, reused = self._pool.take(self.connect_timeout_s or hop_timeout)
        try:
            conn.sock.settimeout(hop_timeout)
            try:
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
            except _STALE:
                if not reused:
                    raise
                conn.close()
                conn, _ = self._pool.take(self.connect_timeout_s or hop_timeout)
                conn.sock.settimeout(hop_timeout)
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
            text = resp.read().decode("utf-8", errors="replace")
        except BaseException:
            conn.close()
            raise
        if resp.will_close:
            conn.close()
        else:
            self._pool.give(conn)
        return resp.status, text

    async def _rest_call(self, path: str, payload: dict) -> dict:
        url = f"http://{self._target}{path}"
        # the active span's W3C traceparent rides every hop and every retry
        tp = current_traceparent()
        headers = {"Content-Type": "application/json"}
        if tp:
            headers["traceparent"] = tp
        body = json.dumps(payload).encode()
        last_err: Optional[Exception] = None
        for attempt in range(self.retries):
            # every attempt is clamped to the remaining budget: retries never
            # run past the deadline, and a spent budget raises 504 here
            hop_timeout = effective_timeout(self.timeout_s)
            try:
                status, text = await asyncio.to_thread(self._post, path, body, headers,
                                                       hop_timeout)
                if status != 200:
                    raise SeldonError(f"Remote node {url} returned {status}: {text[:500]}",
                                      status_code=status, reason="REMOTE_NODE_ERROR")
                return json.loads(text)
            except (OSError, http.client.HTTPException, json.JSONDecodeError) as e:
                last_err = e
                d = current_deadline()
                if d is not None and d.remaining_s() <= 0.0:
                    raise DeadlineExceeded(
                        f"deadline exceeded during remote hop to {url}: {e}") from e
                if attempt + 1 < self.retries:
                    await asyncio.sleep(0.05 * (2 ** attempt))
        raise SeldonError(f"Remote node {url} unreachable after {self.retries} attempts: "
                          f"{last_err}", status_code=503, reason="REMOTE_NODE_UNAVAILABLE")

    async def _grpc_call(self, method: str, msg: Any) -> SeldonMessage:
        import grpc

        from seldon_core_tpu_torch.transport.grpc_client import unary_call

        tp = current_traceparent()
        try:
            return await unary_call(self._target, method, msg,
                                    timeout_s=effective_timeout(self.grpc_timeout_s),
                                    metadata=[("traceparent", tp)] if tp else None)
        except grpc.RpcError as e:
            raise _grpc_error(e, self._target) from e

    async def _call(self, rest_path: str, grpc_method: str, msg: Any) -> SeldonMessage:
        if self.endpoint.type == EndpointType.GRPC.value:
            return await self._grpc_call(grpc_method, msg)
        return SeldonMessage.from_dict(await self._rest_call(rest_path, msg.to_dict()))

    def close(self) -> None:
        self._pool.close()

    # -- component contract (raw passthrough) ---------------------------
    async def predict_raw(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._call("/predict", "Predict", msg)

    async def transform_input_raw(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._call("/transform-input", "TransformInput", msg)

    async def transform_output_raw(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._call("/transform-output", "TransformOutput", msg)

    async def route_raw(self, msg: SeldonMessage) -> SeldonMessage:
        return await self._call("/route", "Route", msg)

    async def aggregate_raw(self, msgs: Sequence[SeldonMessage]) -> SeldonMessage:
        return await self._call("/aggregate", "Aggregate",
                                SeldonMessageList(messages=list(msgs)))

    async def send_feedback_raw(self, feedback: Feedback) -> SeldonMessage:
        return await self._call("/send-feedback", "SendFeedback", feedback)


__all__ = ["ANNOTATION_GRPC_READ_TIMEOUT", "ANNOTATION_REST_CONNECTION_TIMEOUT",
           "ANNOTATION_REST_READ_TIMEOUT", "ANNOTATION_REST_RETRIES", "ANNOTATION_WIRE_FORMAT",
           "RemoteComponent", "config_from_annotations"]
