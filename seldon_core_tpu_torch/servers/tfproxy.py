"""TENSORFLOW_SERVER proxy of the port, copied from
``seldon_core_tpu/servers/tfproxy.py`` (the reference's
`integrations/tfserving/TfServingProxy.py:20-125`): forwards predict calls
to an external TF-Serving over REST (``{"instances": ...}`` ->
``/v1/models/<name>:predict``) or, when ``grpc_endpoint`` is given, gRPC
(``/tensorflow.serving.PredictionService/Predict`` with the hand-encoded
TensorProto bytes of ``codec/tensorproto.py``; grpcio only). Host only.

The REST call is the standard library's ``http.client`` (the JAX package
uses ``requests``, which the card's machine may lack). An upstream that
answers non-200, cannot be reached, or fails a gRPC call is 502
``UPSTREAM_ERROR``.
"""

from __future__ import annotations

import http.client
import json
from typing import Dict, Optional, Sequence
from urllib.parse import urlsplit

import numpy as np

from seldon_core_tpu_torch.codec.tensorproto import (decode_predict_response,
                                                     encode_predict_request)
from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.payload import SeldonError

TIMEOUT_S = 30


class TFServingProxy(SeldonComponent):
    def __init__(self, model_uri: str = "", rest_endpoint: str = "http://localhost:8501",
                 grpc_endpoint: str = "", model_name: str = "model",
                 signature_name: str = "serving_default", model_input: str = "inputs",
                 model_output: str = "outputs", **kwargs):
        super().__init__(**kwargs)
        self.rest_endpoint = rest_endpoint.rstrip("/")
        # the reference's rule (`TfServingProxy.py:35-42`): a gRPC endpoint,
        # when given, is the forwarding path
        self.grpc_endpoint = grpc_endpoint
        self.model_name = model_name
        self.signature_name = signature_name
        self.model_input = model_input
        self.model_output = model_output
        self._channel = None

    def _grpc_predict(self, arr: np.ndarray) -> np.ndarray:
        import grpc

        if self._channel is None:
            self._channel = grpc.insecure_channel(self.grpc_endpoint)
        rpc = self._channel.unary_unary("/tensorflow.serving.PredictionService/Predict",
                                        request_serializer=lambda b: b,
                                        response_deserializer=lambda b: b)
        req = encode_predict_request(arr, self.model_name, self.signature_name,
                                     self.model_input)
        try:
            resp = rpc(req, timeout=TIMEOUT_S)
        except grpc.RpcError as e:
            raise SeldonError(f"TF-Serving gRPC failed: {e.code()} {e.details()}",
                              status_code=502, reason="UPSTREAM_ERROR") from e
        out = decode_predict_response(resp, self.model_output)
        return out[None, :] if out.ndim == 1 else out

    def _rest_predict(self, arr: np.ndarray) -> np.ndarray:
        url = urlsplit(self.rest_endpoint)
        path = f"{url.path}/v1/models/{self.model_name}:predict"
        body = json.dumps({"signature_name": self.signature_name,
                           "instances": arr.tolist()}).encode()
        conn_cls = (http.client.HTTPSConnection if url.scheme == "https"
                    else http.client.HTTPConnection)
        conn = conn_cls(url.hostname, url.port, timeout=TIMEOUT_S)
        try:
            conn.request("POST", path, body=body, headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            status, text = resp.status, resp.read().decode("utf-8", errors="replace")
        except (OSError, http.client.HTTPException) as e:
            raise SeldonError(f"TF-Serving unreachable at {self.rest_endpoint}: {e}",
                              status_code=502, reason="UPSTREAM_ERROR") from e
        finally:
            conn.close()
        if status != 200:
            raise SeldonError(f"TF-Serving returned {status}: {text[:500]}", status_code=502,
                              reason="UPSTREAM_ERROR")
        payload = json.loads(text)
        if "predictions" not in payload:
            raise SeldonError(f"TF-Serving response missing predictions: "
                              f"{json.dumps(payload)[:500]}")
        return np.asarray(payload["predictions"])

    def predict(self, X: np.ndarray, names: Sequence[str], meta: Optional[Dict] = None):
        arr = np.asarray(X)
        if self.grpc_endpoint:
            return self._grpc_predict(arr)
        return self._rest_predict(arr)
