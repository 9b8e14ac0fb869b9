"""TensorProto / PredictRequest wire codec of the port, for the TF-Serving
proxy (``servers/tfproxy.py``): a copy of ``seldon_core_tpu/codec/
tensorproto.py``.

Pure host payload converters, protobuf bytes in and numpy out, encoded
and decoded by hand against tensorflow/core/framework/types.proto: no
tensorflow or tensorflow-serving-api import, so a graph reaches an external
TF-Serving without the TF runtime.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

from seldon_core_tpu_torch.contracts.payload import SeldonError

# TensorProto dtype enum values (tensorflow/core/framework/types.proto)
_DT_FLOAT = 1
_DT_DOUBLE = 2
_DT_INT32 = 3
_DT_INT64 = 9


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def encode_predict_request(arr: np.ndarray, model_name: str, signature_name: str,
                           input_name: str) -> bytes:
    """tensorflow.serving.PredictRequest wire bytes: model_spec{name,
    signature_name} + inputs[input_name] = TensorProto(dtype, shape,
    float_val/double_val packed)."""
    arr = np.asarray(arr)
    flat = arr.reshape(-1)
    if arr.dtype == np.float64:
        dtype, val_field = _DT_DOUBLE, 6
        packed = struct.pack("<%dd" % flat.size, *flat.tolist())
    elif np.issubdtype(arr.dtype, np.integer):
        # int inputs stay ints on the wire (token-id models): int32 ->
        # int_val (7), anything wider -> int64_val (10); protobuf varints
        # encode negatives as 10-byte two's complement
        if arr.dtype.itemsize <= 4 and arr.dtype != np.uint32:
            dtype, val_field = _DT_INT32, 7
        else:
            dtype, val_field = _DT_INT64, 10
        packed = b"".join(
            _varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in flat.tolist())
    else:
        arr = arr.astype(np.float32)
        flat = arr.reshape(-1)
        dtype, val_field = _DT_FLOAT, 5
        packed = struct.pack("<%df" % flat.size, *flat.tolist())
    # TensorShapeProto: repeated Dim dim = 2; Dim.size = 1 (int64)
    shape = b"".join(_len_delim(2, _tag(1, 0) + _varint(d)) for d in arr.shape)
    tensor = (
        _tag(1, 0) + _varint(dtype)
        + _len_delim(2, shape)
        + _len_delim(val_field, packed)
    )
    model_spec = (
        _len_delim(1, model_name.encode())
        + _len_delim(3, signature_name.encode())
    )
    entry = _len_delim(1, input_name.encode()) + _len_delim(2, tensor)
    return _len_delim(1, model_spec) + _len_delim(2, entry)


def _read_varint(buf: bytes, off: int):
    shift = 0
    val = 0
    while True:
        b = buf[off]
        off += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, off
        shift += 7


def _iter_fields(buf: bytes):
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, off = _read_varint(buf, off)
        elif wire == 2:
            ln, off = _read_varint(buf, off)
            val = buf[off:off + ln]
            off += ln
        elif wire == 5:
            val = buf[off:off + 4]
            off += 4
        elif wire == 1:
            val = buf[off:off + 8]
            off += 8
        else:
            raise SeldonError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _signed64(v: int) -> int:
    """Protobuf varints carry negatives as 64-bit two's complement."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _varint_list(val, wire) -> list:
    """Decode an int_val/int64_val field occurrence: packed (wire 2) holds
    back-to-back varints; unpacked (wire 0) is a single value."""
    if wire == 0:
        return [_signed64(val)]
    out = []
    off = 0
    while off < len(val):
        v, off = _read_varint(val, off)
        out.append(_signed64(v))
    return out


def decode_tensor_proto(buf: bytes) -> np.ndarray:
    dtype = _DT_FLOAT
    dims = []
    floats: list = []
    doubles: list = []
    ints: list = []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 0:
            dtype = val
        elif field == 2 and wire == 2:  # tensor_shape
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 2 and w2 == 2:  # Dim
                    for f3, w3, v3 in _iter_fields(v2):
                        if f3 == 1 and w3 == 0:
                            dims.append(v3)
        elif field == 5:  # float_val (packed or repeated)
            if wire == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif field == 6:  # double_val
            if wire == 2:
                doubles.extend(struct.unpack(f"<{len(val) // 8}d", val))
            else:
                doubles.append(struct.unpack("<d", val)[0])
        elif field == 7:  # int_val (DT_INT32 and narrower)
            ints.extend(_varint_list(val, wire))
        elif field == 10:  # int64_val
            ints.extend(_varint_list(val, wire))
    if dtype == _DT_DOUBLE:
        arr = np.asarray(doubles, dtype=np.float64)
    elif dtype == _DT_FLOAT:
        arr = np.asarray(floats, dtype=np.float32)
    elif dtype == _DT_INT32:
        arr = np.asarray(ints, dtype=np.int32)
    elif dtype == _DT_INT64:
        arr = np.asarray(ints, dtype=np.int64)
    else:
        raise SeldonError(
            f"TF-Serving returned TensorProto dtype {dtype}, which this proxy "
            "does not decode (supported: DT_FLOAT/DT_DOUBLE/DT_INT32/DT_INT64)",
            status_code=502, reason="UPSTREAM_ERROR")
    if dims and int(np.prod(dims)) == arr.size:
        arr = arr.reshape(dims)
    return arr


def decode_predict_response(buf: bytes, output_name: str) -> np.ndarray:
    """tensorflow.serving.PredictResponse: outputs map (field 1); returns the
    named output, or the single output when only one is present."""
    outputs: Dict[str, np.ndarray] = {}
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:
            key = ""
            tensor = b""
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    key = v2.decode()
                elif f2 == 2 and w2 == 2:
                    tensor = v2
            outputs[key] = decode_tensor_proto(tensor)
    if output_name in outputs:
        return outputs[output_name]
    if len(outputs) == 1:
        return next(iter(outputs.values()))
    raise SeldonError(
        f"TF-Serving response missing output {output_name!r} "
        f"(has {sorted(outputs)})", status_code=502, reason="UPSTREAM_ERROR")
