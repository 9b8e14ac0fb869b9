"""SageMaker serving proxy of the port, ported from
``seldon_core_tpu/integrations/sagemaker.py`` (the reference's
`integrations/sagemaker/SagemakerProxy.py:33`): a MODEL component that
forwards the feature batch to a SageMaker container's ``/invocations``
endpoint and returns the decoded result, so a SageMaker-hosted model slots
into an inference graph like any other unit. JSON in; JSON or CSV out.

The JAX package posts through a ``requests`` session; here one keep-alive
``http.client`` connection a thread (``http://`` or ``https://`` with the
system's roots), reopened after a failure.
"""

from __future__ import annotations

import http.client
import json
import threading
from typing import Any, Dict, Optional, Sequence
from urllib.parse import urlsplit

import numpy as np

from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.payload import SeldonError


class SageMakerProxy(SeldonComponent):
    def __init__(self, endpoint: str = "", timeout_s: float = 10.0, **kwargs: Any):
        super().__init__(**kwargs)
        if not endpoint:
            raise SeldonError("SageMakerProxy needs endpoint=<container url>", status_code=500)
        self.endpoint = endpoint.rstrip("/")
        self.timeout_s = float(timeout_s)
        self._local = threading.local()  # a connection a thread; rebuilt after unpickling

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_local", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._local = threading.local()

    def _post(self, body: bytes):
        """POST ``body`` to ``/invocations``: (status, content type, bytes)."""
        parts = urlsplit(self.endpoint)
        conn = getattr(self._local, "conn", None)
        if conn is None:
            cls = (http.client.HTTPSConnection if parts.scheme == "https"
                   else http.client.HTTPConnection)
            conn = self._local.conn = cls(parts.hostname, parts.port, timeout=self.timeout_s)
        try:
            conn.request("POST", parts.path + "/invocations", body=body,
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, r.getheader("content-type", "application/json"), r.read()
        except Exception:
            conn.close()
            self._local.conn = None
            raise

    def predict(self, X, names: Sequence[str], meta: Optional[Dict] = None) -> np.ndarray:
        X = np.asarray(X)
        status, content_type, content = self._post(json.dumps(X.tolist()).encode())
        if status != 200:
            text = content.decode("utf-8", "replace")
            raise SeldonError(
                f"SageMaker endpoint error {status}: {text[:200]}",
                reason="MICROSERVICE_BAD_RESPONSE",
                status_code=502,
            )
        if "csv" in content_type:
            rows = [
                [float(v) for v in line.split(",")]
                for line in content.decode().strip().splitlines()
                if line
            ]
            result = np.asarray(rows)
        else:
            result = np.asarray(json.loads(content))
        # a flat list of one prediction per input row must stay row-aligned,
        # not transpose into a single (1, N) row
        if result.ndim == 1 and X.ndim >= 2 and len(result) == X.shape[0] > 1:
            return result[:, None]
        return np.atleast_2d(result)


__all__ = ["SageMakerProxy"]
