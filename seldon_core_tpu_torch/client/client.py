"""SeldonClient of the port: one client for every serving path, ported from
``seldon_core_tpu/client/client.py`` (the reference's
`python/seldon_core/seldon_client.py:104+`) with the same surface.

Three endpoint kinds:

- ``engine``: the external API of a predictor (`/api/v0.1/predictions`,
  `/api/v0.1/feedback`; gRPC service ``Seldon``).
- ``microservice``: one component's internal API (`/predict`,
  `/transform-input`, ...; gRPC services Model/Router/Transformer/Combiner).
- ``gateway``: the engine API through the cluster ingress: REST requests go
  to ``/seldon/<namespace>/<deployment>/api/v0.1/...`` (the route
  ``controlplane/render.py`` renders), gRPC carries ``seldon`` and
  ``namespace`` metadata for the ingress to route on.

REST goes over the standard library (``http.client``, and ``ssl`` for
https), one connection a call; the JAX package's client uses ``requests``,
which the card's machine is not known to carry. TLS: ``ssl=True`` switches
REST to https (``ca_cert`` verifies the server, else the system roots;
``client_cert`` / ``client_key`` for mutual TLS) and gRPC to a secure
channel from the same PEMs; ``auth_token`` rides as a Bearer header / gRPC
``authorization`` metadata. gRPC goes through ``transport/grpc_client.py``,
imported at the first gRPC call.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import ssl as _ssl
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from seldon_core_tpu_torch.contracts.payload import Feedback, SeldonMessage, SeldonMessageList


@dataclasses.dataclass
class ClientResponse:
    success: bool
    msg: Optional[SeldonMessage]
    raw: Optional[Dict[str, Any]]
    error: Optional[str] = None

    @property
    def data(self) -> Optional[np.ndarray]:
        if self.msg is None or self.msg.data is None:
            return None
        return self.msg.data.to_numpy()


def _to_message(payload: Any, bin_data=None, str_data=None, json_data=None) -> SeldonMessage:
    if isinstance(payload, SeldonMessage):
        return payload
    if bin_data is not None:
        return SeldonMessage.from_bytes(bytes(bin_data))
    if str_data is not None:
        return SeldonMessage.from_str(str_data)
    if json_data is not None:
        return SeldonMessage.from_json_data(json_data)
    if payload is None:
        payload = np.array([[1.0]])
    return SeldonMessage.from_array(np.asarray(payload))


class SeldonClient:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8000,
        transport: str = "rest",
        endpoint_kind: str = "engine",
        timeout_s: float = 10.0,
        names: Optional[Sequence[str]] = None,
        deployment_name: Optional[str] = None,
        namespace: str = "default",
        ssl: bool = False,
        ca_cert: Optional[str] = None,
        client_cert: Optional[str] = None,
        client_key: Optional[str] = None,
        auth_token: Optional[str] = None,
    ):
        if transport not in ("rest", "grpc"):
            raise ValueError(f"transport must be rest|grpc, got {transport}")
        if endpoint_kind not in ("engine", "microservice", "gateway"):
            raise ValueError(
                f"endpoint_kind must be engine|microservice|gateway, got {endpoint_kind}")
        if endpoint_kind == "gateway" and not deployment_name:
            raise ValueError("gateway endpoint needs deployment_name")
        self.host = host
        self.port = int(port)
        self.transport = transport
        self.endpoint_kind = endpoint_kind
        self.timeout_s = float(timeout_s)
        self.names = list(names or [])
        self.deployment_name = deployment_name
        self.namespace = namespace
        self.ssl = bool(ssl)
        self.ca_cert = ca_cert
        self.client_cert = client_cert
        self.client_key = client_key
        self.auth_token = auth_token
        self._channel_credentials = None  # built once on the first gRPC call
        self._ssl_context: Optional[_ssl.SSLContext] = None

    # ------------------------------------------------------------- REST
    def _rest_path(self, path: str) -> str:
        if self.endpoint_kind == "gateway":
            return f"/seldon/{self.namespace}/{self.deployment_name}{path}"
        return path

    def _connection(self) -> http.client.HTTPConnection:
        if not self.ssl:
            return http.client.HTTPConnection(self.host, self.port, timeout=self.timeout_s)
        if self._ssl_context is None:
            ctx = _ssl.create_default_context(cafile=self.ca_cert)
            if self.client_cert:
                ctx.load_cert_chain(self.client_cert, self.client_key)
            self._ssl_context = ctx
        return http.client.HTTPSConnection(self.host, self.port, timeout=self.timeout_s,
                                           context=self._ssl_context)

    def _rest_call(self, path: str, body: Dict[str, Any]) -> ClientResponse:
        headers = {"Content-Type": "application/json"}
        if self.auth_token:
            headers["Authorization"] = f"Bearer {self.auth_token}"
        try:
            conn = self._connection()
            try:
                conn.request("POST", self._rest_path(path), body=json.dumps(body),
                             headers=headers)
                r = conn.getresponse()
                status, text = r.status, r.read()
            finally:
                conn.close()
            raw = json.loads(text)
        except Exception as e:  # connection / TLS / JSON errors
            return ClientResponse(False, None, None, error=str(e))
        if status != 200:
            return ClientResponse(False, None, raw, error=json.dumps(raw))
        return ClientResponse(True, SeldonMessage.from_dict(raw), raw)

    # ------------------------------------------------------------- gRPC
    def _grpc_metadata(self) -> Optional[List]:
        md = []
        if self.endpoint_kind == "gateway":
            # the ingress routes on these (reference: seldon_client.py:1137+)
            md += [("seldon", self.deployment_name), ("namespace", self.namespace)]
        if self.auth_token:
            md.append(("authorization", f"Bearer {self.auth_token}"))
        return md or None

    def _grpc_credentials(self):
        if not self.ssl:
            return None
        if self._channel_credentials is None:
            from seldon_core_tpu_torch.transport.grpc_client import make_channel_credentials

            self._channel_credentials = make_channel_credentials(
                self.ca_cert, self.client_cert, self.client_key)
        return self._channel_credentials

    def _grpc_call(self, method: str, msg: Any, service: str) -> ClientResponse:
        try:
            from seldon_core_tpu_torch.transport import grpc_client

            out = grpc_client.call_sync(
                f"{self.host}:{self.port}", method, msg, service=service,
                timeout_s=self.timeout_s, credentials=self._grpc_credentials(),
                metadata=self._grpc_metadata())
        except Exception as e:
            return ClientResponse(False, None, None, error=str(e))
        return ClientResponse(True, out, out.to_dict())

    # ------------------------------------------------------------ methods
    def predict(self, data: Any = None, names: Optional[Sequence[str]] = None, bin_data=None,
                str_data=None, json_data=None) -> ClientResponse:
        msg = _to_message(data, bin_data, str_data, json_data)
        if (names or self.names) and msg.data is not None:
            msg.data.names = list(names or self.names)
        if self.transport == "rest":
            path = "/predict" if self.endpoint_kind == "microservice" else "/api/v0.1/predictions"
            return self._rest_call(path, msg.to_dict())
        service = "Model" if self.endpoint_kind == "microservice" else "Seldon"
        return self._grpc_call("Predict", msg, service)

    def feedback(self, request: Optional[Union[SeldonMessage, Dict]] = None,
                 response: Optional[Union[SeldonMessage, Dict]] = None, reward: float = 0.0,
                 truth: Any = None) -> ClientResponse:
        fb = Feedback(
            request=_as_msg(request),
            response=_as_msg(response),
            reward=float(reward),
            truth=SeldonMessage.from_array(np.asarray(truth)) if truth is not None else None,
        )
        if self.transport == "rest":
            path = "/send-feedback" if self.endpoint_kind == "microservice" else "/api/v0.1/feedback"
            return self._rest_call(path, fb.to_dict())
        service = "Model" if self.endpoint_kind == "microservice" else "Seldon"
        return self._grpc_call("SendFeedback", fb, service)

    # microservice-only graph methods
    def transform_input(self, data: Any, names: Optional[Sequence[str]] = None) -> ClientResponse:
        return self._unit_call("TransformInput", "/transform-input", data, names, "Transformer")

    def transform_output(self, data: Any, names: Optional[Sequence[str]] = None) -> ClientResponse:
        return self._unit_call("TransformOutput", "/transform-output", data, names,
                               "OutputTransformer")

    def route(self, data: Any, names: Optional[Sequence[str]] = None) -> ClientResponse:
        return self._unit_call("Route", "/route", data, names, "Router")

    def aggregate(self, datas: Sequence[Any]) -> ClientResponse:
        msgs = SeldonMessageList(messages=[_to_message(d) for d in datas])
        if self.transport == "rest":
            return self._rest_call("/aggregate", msgs.to_dict())
        return self._grpc_call("Aggregate", msgs, "Combiner")

    def _unit_call(self, method, path, data, names, service) -> ClientResponse:
        if self.endpoint_kind != "microservice":
            raise ValueError(f"{method} is a microservice-level call")
        msg = _to_message(data)
        if (names or self.names) and msg.data is not None:
            msg.data.names = list(names or self.names)
        if self.transport == "rest":
            return self._rest_call(path, msg.to_dict())
        return self._grpc_call(method, msg, service)


def _as_msg(x: Optional[Union[SeldonMessage, Dict]]) -> Optional[SeldonMessage]:
    if x is None:
        return None
    if isinstance(x, SeldonMessage):
        return x
    return SeldonMessage.from_dict(x)


__all__ = ["ClientResponse", "SeldonClient"]
