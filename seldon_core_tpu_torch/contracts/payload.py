"""Payload schema of the port: ``SeldonMessage`` and its parts.

Copied from ``seldon_core_tpu/contracts/payload.py`` (the port imports
nothing of the JAX package). Wire-compatible with the reference proto-JSON
(`proto/prediction.proto:14-91`):

    {"data": {"names": [...], "tensor": {"shape": [...], "values": [...]}}}
    {"data": {"names": [...], "ndarray": [[...], ...]}}
    {"binData": "<base64>"} | {"strData": "..."} | {"jsonData": <any>}
    meta: {"puid", "tags", "routing", "requestPath", "metrics"}
    status: {"code", "info", "reason", "status"}

``DefaultData.array`` holds the live numpy array; JSON encode/decode
happens once at the process edge. A ``tftensor`` payload answers 400, as in
the JAX package (no tensorflow).
"""

from __future__ import annotations

import base64
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

ArrayLike = Any  # np.ndarray (a torch tensor is converted at the response edge)


class SeldonError(Exception):
    """Framework error carrying an HTTP-ish status code and structured payload."""

    status_code = 400

    def __init__(self, message: str, status_code: Optional[int] = None, reason: str = "MICROSERVICE_BAD_DATA"):
        super().__init__(message)
        self.message = message
        if status_code is not None:
            self.status_code = status_code
        self.reason = reason

    def to_status(self) -> "Status":
        return Status(code=self.status_code, info=self.message, reason=self.reason, status="FAILURE")


class MetricType(str, Enum):
    COUNTER = "COUNTER"
    GAUGE = "GAUGE"
    TIMER = "TIMER"


@dataclass(slots=True)
class Metric:
    """In-band custom metric (`proto/prediction.proto:48-58`)."""

    key: str
    type: str = MetricType.COUNTER.value
    value: float = 0.0
    tags: Dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"key": self.key, "type": self.type, "value": self.value}
        if self.tags:
            d["tags"] = dict(self.tags)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Metric":
        return cls(
            key=d.get("key", ""),
            type=d.get("type", MetricType.COUNTER.value) or MetricType.COUNTER.value,
            value=float(d.get("value", 0.0)),
            tags=dict(d.get("tags", {}) or {}),
        )


@dataclass(slots=True)
class Meta:
    """Request/response metadata (`proto/prediction.proto:40-46`)."""

    puid: str = ""
    tags: Dict[str, Any] = field(default_factory=dict)
    routing: Dict[str, int] = field(default_factory=dict)
    request_path: Dict[str, str] = field(default_factory=dict)
    metrics: List[Metric] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if self.puid:
            d["puid"] = self.puid
        if self.tags:
            d["tags"] = dict(self.tags)
        if self.routing:
            d["routing"] = dict(self.routing)
        if self.request_path:
            d["requestPath"] = dict(self.request_path)
        if self.metrics:
            d["metrics"] = [m.to_dict() for m in self.metrics]
        return d

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "Meta":
        d = d or {}
        return cls(
            puid=d.get("puid", "") or "",
            tags=dict(d.get("tags", {}) or {}),
            routing={k: int(v) for k, v in (d.get("routing", {}) or {}).items()},
            request_path=dict(d.get("requestPath", {}) or {}),
            metrics=[Metric.from_dict(m) for m in (d.get("metrics", []) or [])],
        )

    def copy(self) -> "Meta":
        return Meta(
            puid=self.puid,
            tags=dict(self.tags),
            routing=dict(self.routing),
            request_path=dict(self.request_path),
            metrics=list(self.metrics),
        )


@dataclass(slots=True)
class Status:
    """Outcome status (`proto/prediction.proto:64-75`)."""

    code: int = 200
    info: str = ""
    reason: str = ""
    status: str = "SUCCESS"  # SUCCESS | FAILURE

    def to_dict(self) -> Dict[str, Any]:
        return {"code": self.code, "info": self.info, "reason": self.reason, "status": self.status}

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "Status":
        d = d or {}
        return cls(
            code=int(d.get("code", 200)),
            info=d.get("info", ""),
            reason=d.get("reason", ""),
            status=d.get("status", "SUCCESS") or "SUCCESS",
        )


# DefaultData encodings on the wire.
ENC_TENSOR = "tensor"
ENC_NDARRAY = "ndarray"
ENC_TFTENSOR = "tftensor"


@dataclass(slots=True)
class DefaultData:
    """Named tensor payload (`proto/prediction.proto:26-38`).

    ``array`` is the live numpy array. ``encoding`` remembers
    which wire form the data arrived in (tensor | ndarray | tftensor) so
    responses can mirror the request encoding, matching the reference's
    construct-response rules (`python/seldon_core/utils.py:443-461`).
    """

    names: List[str] = field(default_factory=list)
    array: Optional[ArrayLike] = None
    encoding: str = ENC_TENSOR
    # ndarray payloads may hold non-numeric nested lists; keep the raw form.
    raw_ndarray: Optional[List[Any]] = None

    def to_numpy(self) -> np.ndarray:
        if self.array is not None:
            return np.asarray(self.array)
        return np.asarray(self.raw_ndarray, dtype=object)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if self.names:
            d["names"] = list(self.names)
        if self.encoding == ENC_TENSOR:
            arr = np.asarray(self.array)
            d["tensor"] = {"shape": list(arr.shape), "values": arr.ravel().tolist()}
        elif self.encoding == ENC_NDARRAY:
            if self.raw_ndarray is not None and self.array is None:
                d["ndarray"] = self.raw_ndarray
            else:
                d["ndarray"] = np.asarray(self.array).tolist()
        else:
            raise SeldonError(f"Unsupported DefaultData encoding for JSON: {self.encoding}")
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DefaultData":
        names = list(d.get("names", []) or [])
        if "tensor" in d:
            t = d["tensor"]
            values = np.asarray(t.get("values", []), dtype=np.float64)
            shape = tuple(int(s) for s in t.get("shape", []) or [values.size])
            try:
                arr = values.reshape(shape)
            except ValueError as e:
                raise SeldonError(f"tensor values do not fit shape {shape}: {e}")
            return cls(names=names, array=arr, encoding=ENC_TENSOR)
        if "ndarray" in d:
            raw = d["ndarray"]
            arr: Optional[np.ndarray]
            try:
                arr = np.asarray(raw)
                if arr.dtype == object:
                    arr = None
            except Exception:
                arr = None
            return cls(names=names, array=arr, encoding=ENC_NDARRAY, raw_ndarray=raw)
        if "tftensor" in d:
            raise SeldonError(
                "tftensor payloads require tensorflow, which is not available in this "
                "build; use 'tensor' or 'ndarray'",
                status_code=400,
            )
        raise SeldonError("DefaultData requires one of: tensor, ndarray, tftensor")


@dataclass(slots=True)
class SeldonMessage:
    """The one message type flowing through graphs (`proto/prediction.proto:14-24`).

    Exactly one of (data, bin_data, str_data, json_data) is set; ``which`` names
    the active oneof arm ('data' | 'binData' | 'strData' | 'jsonData' | '').
    """

    status: Optional[Status] = None
    meta: Meta = field(default_factory=Meta)
    data: Optional[DefaultData] = None
    bin_data: Optional[bytes] = None
    str_data: Optional[str] = None
    json_data: Any = None
    which: str = ""

    # ---- constructors -------------------------------------------------
    @classmethod
    def from_array(
        cls,
        array: ArrayLike,
        names: Optional[Sequence[str]] = None,
        encoding: str = ENC_TENSOR,
        meta: Optional[Meta] = None,
    ) -> "SeldonMessage":
        return cls(
            meta=meta or Meta(),
            data=DefaultData(names=list(names or []), array=array, encoding=encoding),
            which="data",
        )

    @classmethod
    def from_bytes(cls, payload: bytes, meta: Optional[Meta] = None) -> "SeldonMessage":
        return cls(meta=meta or Meta(), bin_data=payload, which="binData")

    @classmethod
    def from_str(cls, payload: str, meta: Optional[Meta] = None) -> "SeldonMessage":
        return cls(meta=meta or Meta(), str_data=payload, which="strData")

    @classmethod
    def from_json_data(cls, payload: Any, meta: Optional[Meta] = None) -> "SeldonMessage":
        return cls(meta=meta or Meta(), json_data=payload, which="jsonData")

    # ---- payload access ----------------------------------------------
    def payload(self) -> Union[np.ndarray, bytes, str, Any, None]:
        """The user-facing payload: array for data, else bytes/str/json."""
        if self.which == "data" and self.data is not None:
            return self.data.to_numpy()
        if self.which == "binData":
            return self.bin_data
        if self.which == "strData":
            return self.str_data
        if self.which == "jsonData":
            return self.json_data
        return None

    @property
    def names(self) -> List[str]:
        return self.data.names if self.data is not None else []

    # ---- wire codec ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if self.status is not None:
            d["status"] = self.status.to_dict()
        meta_d = self.meta.to_dict()
        # Keep "meta" present (possibly {}) to mirror reference responses which
        # always attach a meta object (`utils.py:construct_response_json`).
        d["meta"] = meta_d
        if self.which == "data" and self.data is not None:
            d["data"] = self.data.to_dict()
        elif self.which == "binData":
            d["binData"] = base64.b64encode(self.bin_data or b"").decode("utf-8")
        elif self.which == "strData":
            d["strData"] = self.str_data
        elif self.which == "jsonData":
            d["jsonData"] = self.json_data
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SeldonMessage":
        if not isinstance(d, dict):
            raise SeldonError(f"SeldonMessage must be a JSON object, got {type(d).__name__}")
        msg = cls(
            status=Status.from_dict(d["status"]) if "status" in d else None,
            meta=Meta.from_dict(d.get("meta")),
        )
        if "data" in d:
            msg.data = DefaultData.from_dict(d["data"])
            msg.which = "data"
        elif "binData" in d:
            raw = d["binData"]
            if isinstance(raw, str):
                try:
                    msg.bin_data = base64.b64decode(raw)
                except Exception as e:
                    raise SeldonError(f"binData is not valid base64: {e}")
            else:
                msg.bin_data = bytes(raw)
            msg.which = "binData"
        elif "strData" in d:
            msg.str_data = d["strData"]
            msg.which = "strData"
        elif "jsonData" in d:
            msg.json_data = d["jsonData"]
            msg.which = "jsonData"
        return msg


@dataclass(slots=True)
class SeldonMessageList:
    """`proto/prediction.proto:60-62`."""

    messages: List[SeldonMessage] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {"seldonMessages": [m.to_dict() for m in self.messages]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SeldonMessageList":
        return cls(messages=[SeldonMessage.from_dict(m) for m in d.get("seldonMessages", [])])


@dataclass(slots=True)
class Feedback:
    """Reward/truth feedback (`proto/prediction.proto:77-82`)."""

    request: Optional[SeldonMessage] = None
    response: Optional[SeldonMessage] = None
    reward: float = 0.0
    truth: Optional[SeldonMessage] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"reward": self.reward}
        if self.request is not None:
            d["request"] = self.request.to_dict()
        if self.response is not None:
            d["response"] = self.response.to_dict()
        if self.truth is not None:
            d["truth"] = self.truth.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Feedback":
        return cls(
            request=SeldonMessage.from_dict(d["request"]) if "request" in d else None,
            response=SeldonMessage.from_dict(d["response"]) if "response" in d else None,
            reward=float(d.get("reward", 0.0)),
            truth=SeldonMessage.from_dict(d["truth"]) if "truth" in d else None,
        )


__all__ = ["ENC_NDARRAY", "ENC_TENSOR", "ENC_TFTENSOR", "DefaultData", "Feedback", "Meta",
           "Metric", "MetricType", "SeldonError", "SeldonMessage", "SeldonMessageList", "Status"]
