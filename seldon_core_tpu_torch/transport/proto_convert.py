"""Converters between the in-memory payload dataclasses and the wire protos.

Copied from ``seldon_core_tpu/transport/proto_convert.py`` over the port's
own payload classes (``contracts/payload.py``) and its copy of the generated
stubs (``transport/proto/prediction_pb2.py``). It runs only at the gRPC edge.
"""

from __future__ import annotations

from typing import Any

import numpy as np
from google.protobuf import json_format
from google.protobuf.struct_pb2 import ListValue, Value

from seldon_core_tpu_torch.contracts.payload import (
    ENC_NDARRAY,
    ENC_TENSOR,
    DefaultData,
    Feedback,
    Meta,
    Metric,
    SeldonError,
    SeldonMessage,
    SeldonMessageList,
    Status,
)
from seldon_core_tpu_torch.transport.proto import prediction_pb2 as pb


# ---------------------------------------------------------------------------
# to proto
# ---------------------------------------------------------------------------

def meta_to_proto(meta: Meta) -> pb.Meta:
    out = pb.Meta()
    out.puid = meta.puid
    for k, v in meta.tags.items():
        json_format.ParseDict(v, out.tags[k]) if isinstance(v, (dict, list)) else _set_value(out.tags[k], v)
    for k, v in meta.routing.items():
        out.routing[k] = v
    for k, v in meta.request_path.items():
        out.requestPath[k] = v
    for m in meta.metrics:
        pm = out.metrics.add()
        pm.key = m.key
        pm.type = pb.Metric.MetricType.Value(m.type)
        pm.value = m.value
        for tk, tv in m.tags.items():
            pm.tags[tk] = str(tv)
    return out


def _set_value(value: Value, v: Any) -> None:
    if v is None:
        value.null_value = 0
    elif isinstance(v, bool):
        value.bool_value = v
    elif isinstance(v, (int, float)):
        value.number_value = float(v)
    elif isinstance(v, str):
        value.string_value = v
    else:
        json_format.ParseDict(v, value)


def message_to_proto(msg: SeldonMessage) -> pb.SeldonMessage:
    out = pb.SeldonMessage()
    if msg.status is not None:
        out.status.code = msg.status.code
        out.status.info = msg.status.info
        out.status.reason = msg.status.reason
        out.status.status = pb.Status.StatusFlag.Value(msg.status.status)
    out.meta.CopyFrom(meta_to_proto(msg.meta))
    if msg.which == "data" and msg.data is not None:
        d = msg.data
        out.data.names.extend(d.names)
        if d.encoding == ENC_TENSOR:
            arr = np.asarray(d.array, dtype=np.float64)
            out.data.tensor.shape.extend(arr.shape)
            out.data.tensor.values.extend(arr.ravel().tolist())
        else:
            raw = d.raw_ndarray if (d.raw_ndarray is not None and d.array is None) else np.asarray(d.array).tolist()
            out.data.ndarray.CopyFrom(json_format.ParseDict(raw, ListValue()))
    elif msg.which == "binData":
        out.binData = msg.bin_data or b""
    elif msg.which == "strData":
        out.strData = msg.str_data or ""
    elif msg.which == "jsonData":
        json_format.ParseDict(msg.json_data, out.jsonData) if isinstance(
            msg.json_data, (dict, list)
        ) else _set_value(out.jsonData, msg.json_data)
    return out


def list_to_proto(lst: SeldonMessageList) -> pb.SeldonMessageList:
    out = pb.SeldonMessageList()
    for m in lst.messages:
        out.seldonMessages.add().CopyFrom(message_to_proto(m))
    return out


def feedback_to_proto(fb: Feedback) -> pb.Feedback:
    out = pb.Feedback()
    if fb.request is not None:
        out.request.CopyFrom(message_to_proto(fb.request))
    if fb.response is not None:
        out.response.CopyFrom(message_to_proto(fb.response))
    out.reward = fb.reward
    if fb.truth is not None:
        out.truth.CopyFrom(message_to_proto(fb.truth))
    return out


# ---------------------------------------------------------------------------
# from proto
# ---------------------------------------------------------------------------

def meta_from_proto(meta: pb.Meta) -> Meta:
    return Meta(
        puid=meta.puid,
        tags={k: json_format.MessageToDict(v) for k, v in meta.tags.items()},
        routing=dict(meta.routing),
        request_path=dict(meta.requestPath),
        metrics=[
            Metric(
                key=m.key,
                type=pb.Metric.MetricType.Name(m.type),
                value=m.value,
                tags=dict(m.tags),
            )
            for m in meta.metrics
        ],
    )


def message_from_proto(msg: pb.SeldonMessage) -> SeldonMessage:
    out = SeldonMessage(meta=meta_from_proto(msg.meta))
    if msg.HasField("status"):
        out.status = Status(
            code=msg.status.code,
            info=msg.status.info,
            reason=msg.status.reason,
            status=pb.Status.StatusFlag.Name(msg.status.status),
        )
    which = msg.WhichOneof("data_oneof")
    if which == "data":
        d = msg.data
        names = list(d.names)
        inner = d.WhichOneof("data_oneof")
        if inner == "tensor":
            # packed float64: frombuffer-equivalent fast path
            values = np.array(d.tensor.values, dtype=np.float64)
            shape = tuple(d.tensor.shape) or (values.size,)
            try:
                arr = values.reshape(shape)
            except ValueError as e:
                raise SeldonError(f"tensor values do not fit shape {shape}: {e}")
            out.data = DefaultData(names=names, array=arr, encoding=ENC_TENSOR)
        elif inner == "ndarray":
            raw = json_format.MessageToDict(d.ndarray)
            arr = None
            try:
                a = np.asarray(raw)
                arr = a if a.dtype != object else None
            except Exception:
                arr = None
            out.data = DefaultData(names=names, array=arr, encoding=ENC_NDARRAY, raw_ndarray=raw)
        else:
            raise SeldonError("DefaultData proto carries no tensor/ndarray")
        out.which = "data"
    elif which == "binData":
        out.bin_data = msg.binData
        out.which = "binData"
    elif which == "strData":
        out.str_data = msg.strData
        out.which = "strData"
    elif which == "jsonData":
        out.json_data = json_format.MessageToDict(msg.jsonData)
        out.which = "jsonData"
    return out


def list_from_proto(lst: pb.SeldonMessageList) -> SeldonMessageList:
    return SeldonMessageList(messages=[message_from_proto(m) for m in lst.seldonMessages])


def feedback_from_proto(fb: pb.Feedback) -> Feedback:
    return Feedback(
        request=message_from_proto(fb.request) if fb.HasField("request") else None,
        response=message_from_proto(fb.response) if fb.HasField("response") else None,
        reward=fb.reward,
        truth=message_from_proto(fb.truth) if fb.HasField("truth") else None,
    )
