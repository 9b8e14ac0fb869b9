"""The binary tensor frame: a copy of the frame layer of
``seldon_core_tpu/codec/framing.py``, byte for byte the same layout, for
tensors of numpy and PyTorch:

    offset  size  field
    0       4     magic  b"SFRM"
    4       2     version (u16 LE)
    6       2     flags   (u16 LE, reserved)
    8       4     n_tensors (u32 LE)
    12      4     meta_len  (u32 LE) — UTF-8 JSON byte length
    16      8     payload_len (u64 LE) — total raw tensor bytes
    24      ...   n_tensors table entries:
                    dtype_code u8 | ndim u8 | reserved u16 |
                    offset u64 | nbytes u64 | ndim x dim u64
    ...     ...   meta JSON (UTF-8)
    ...     ...   tensor payload (concatenated raw buffers; offsets in
                  the table are relative to the payload start)

The metadata comes before the payload, so a frame truncated in the payload
still yields it (``decode_frame(buf, meta_only=True)``): the network KV
handoff (``runtime/disagg.py``) recovers a job id this way. Every malformed
input raises ``FrameError`` (a 400 ``SeldonError``), and declared lengths are
checked against ``len(buf)`` before any tensor is made from the buffer.

Tensors go in as numpy arrays or torch tensors. Every CUDA tensor of a frame
leaves the card in ONE bulk copy (``_host_tensors``: the tensors are packed
as bytes on the device and the pack is copied once into pinned host
memory), never tensor by tensor. ``encode_frame_parts`` gives the frame as
its buffers (the header, table and metadata, then each tensor's bytes as a
view), so a sender can write them out without joining them;
``encode_frame`` joins them. A bfloat16 tensor is written as its raw bytes
under the dtype name the JAX codec writes, and decoded with
``torch.frombuffer`` (numpy has no bfloat16); every other dtype decodes to a
numpy view over the buffer, which may be ``bytes``, a ``bytearray`` or a
``memoryview`` (not copied).

The message layer (``encode_message``, ``decode_message``, ``grpc_wrap``)
is not here.
"""

from __future__ import annotations

import json
import struct
import threading
import time
import warnings
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.contracts.payload import SeldonError

MAGIC = b"SFRM"
VERSION = 1

_HEADER = struct.Struct("<4sHHIIQ")          # magic, version, flags, n, meta, payload
_ENTRY = struct.Struct("<BBHQQ")             # dtype, ndim, reserved, offset, nbytes
_DIM = struct.Struct("<Q")

# sanity bounds on the table and metadata; a frame past them is malformed
MAX_TENSORS = 4096
MAX_NDIM = 16
MAX_META_BYTES = 64 << 20

# wire dtype codes. Order is the wire contract — append only.
_DTYPE_NAMES = (
    "float32", "float64", "float16", "bfloat16",
    "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64",
    "bool",
)
_CODE_BY_NAME = {n: i for i, n in enumerate(_DTYPE_NAMES)}
_TORCH_NAMES = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
                torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8",
                torch.bool: "bool"}


class FrameError(SeldonError):
    """Malformed frame: always a clean 400 at the transport edge."""

    def __init__(self, message: str, status_code: int = 400):
        super().__init__(message, status_code=status_code, reason="MALFORMED_FRAME")


# codec tallies: lifetime bytes per path label, encode / decode times
_stats_lock = threading.Lock()
_encode_times_s: List[float] = []
_decode_times_s: List[float] = []
_bytes_total: Dict[str, int] = {}


def _record(kind: str, path: str, nbytes: int, dur_s: float) -> None:
    with _stats_lock:
        (_encode_times_s if kind == "encode" else _decode_times_s).append(dur_s)
        _bytes_total[path] = _bytes_total.get(path, 0) + int(nbytes)


def frame_stats(drain: bool = True) -> Dict[str, Any]:
    """Time samples (drained unless ``drain=False``: each observed once)
    and lifetime byte totals per path label."""
    with _stats_lock:
        out = {"frame_encode_times_s": list(_encode_times_s),
               "frame_decode_times_s": list(_decode_times_s),
               "frame_bytes_total": dict(_bytes_total)}
        if drain:
            _encode_times_s.clear()
            _decode_times_s.clear()
        return out


def _host_tensors(tensors: Sequence[Any]) -> List[Any]:
    """Every tensor on the host: numpy arrays as C-ordered arrays, torch
    tensors as contiguous CPU tensors. The CUDA tensors of each device are
    packed into one byte buffer there and leave the card in one copy into
    pinned host memory; the host tensors are views of that one copy."""
    out: List[Any] = [None] * len(tensors)
    by_device: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(tensors):
        if torch.is_tensor(t):
            if t.device.type == "cpu":
                out[i] = t.contiguous()
            else:
                by_device.setdefault(t.device, []).append(i)
        else:
            # np.asarray(order="C"), not ascontiguousarray: 0-d stays 0-d
            out[i] = np.asarray(t, order="C")
    for dev, idx in by_device.items():
        # each tensor's bytes start 8-byte aligned, so every host view can
        # take its dtype back
        pieces, starts, start = [], [], 0
        for i in idx:
            flat = tensors[i].contiguous().reshape(-1).view(torch.uint8)
            pad = -flat.numel() % 8
            pieces += [flat, torch.zeros((pad,), dtype=torch.uint8, device=dev)]
            starts.append(start)
            start += flat.numel() + pad
        packed = torch.cat(pieces)
        host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(packed)
        for i, s in zip(idx, starts):
            t = tensors[i]
            n = t.numel() * t.element_size()
            out[i] = host[s:s + n].view(t.dtype).reshape(t.shape)
    return out


def _dtype_name(arr: Any) -> str:
    if torch.is_tensor(arr):
        name = _TORCH_NAMES.get(arr.dtype)
        if name is None:
            raise FrameError(f"dtype {arr.dtype} has no frame encoding")
        return name
    return arr.dtype.name


def _raw(arr: Any) -> memoryview:
    """A host tensor's bytes, as a view (no copy)."""
    if torch.is_tensor(arr):
        return memoryview(arr.reshape(-1).view(torch.uint8).numpy())
    return memoryview(arr.reshape(-1).view(np.uint8))


def encode_frame(meta: Dict[str, Any], tensors: Sequence[Any] = (), path: str = "rest") -> bytes:
    """Serialize (JSON-able metadata, tensors) into one frame."""
    return b"".join(encode_frame_parts(meta, tensors, path))


def encode_frame_parts(meta: Dict[str, Any], tensors: Sequence[Any] = (),
                       path: str = "rest") -> List[Any]:
    """One frame as a list of buffers whose concatenation is the frame: the
    header, table and metadata as bytes, then each tensor's raw bytes as a
    view of its host copy."""
    t0 = time.perf_counter()
    arrs = _host_tensors(list(tensors))
    if len(arrs) > MAX_TENSORS:
        raise FrameError(f"{len(arrs)} tensors exceeds the frame cap {MAX_TENSORS}")
    meta_b = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    if len(meta_b) > MAX_META_BYTES:
        raise FrameError(f"frame metadata section exceeds {MAX_META_BYTES} bytes")
    table = bytearray()
    offset = 0
    for arr in arrs:
        name = _dtype_name(arr)
        code = _CODE_BY_NAME.get(name)
        if code is None:
            raise FrameError(f"dtype {name!r} has no frame encoding")
        shape = tuple(arr.shape)
        if len(shape) > MAX_NDIM:
            raise FrameError(f"ndim {len(shape)} exceeds the frame cap {MAX_NDIM}")
        nbytes = arr.nbytes if not torch.is_tensor(arr) else arr.numel() * arr.element_size()
        table += _ENTRY.pack(code, len(shape), 0, offset, nbytes)
        for dim in shape:
            table += _DIM.pack(dim)
        offset += nbytes
    header = _HEADER.pack(MAGIC, VERSION, 0, len(arrs), len(meta_b), offset)
    parts = [b"".join([header, bytes(table), meta_b])] + [_raw(arr) for arr in arrs]
    _record("encode", path, len(parts[0]) + offset, time.perf_counter() - t0)
    return parts


def decode_frame(buf: bytes, *, meta_only: bool = False,
                 path: str = "rest") -> Tuple[Dict[str, Any], List[Any]]:
    """Parse one frame back into (metadata, tensors): numpy views over
    ``buf``, a bfloat16 tensor as a torch tensor over it. ``meta_only=True``
    checks the header, table and metadata and skips the payload, so a frame
    whose payload was truncated or corrupted still yields its metadata."""
    t0 = time.perf_counter()
    if isinstance(buf, (bytearray, memoryview)):
        buf = memoryview(buf).cast("B")
    elif not isinstance(buf, bytes):
        raise FrameError(f"frame must be bytes, got {type(buf).__name__}")
    if len(buf) < _HEADER.size:
        raise FrameError(f"truncated frame header: {len(buf)} bytes < {_HEADER.size}")
    magic, version, _flags, n_tensors, meta_len, payload_len = _HEADER.unpack_from(buf, 0)
    if bytes(magic) != MAGIC:
        raise FrameError(f"bad frame magic {magic!r}")
    if version != VERSION:
        raise FrameError(f"frame version {version} not supported (this build speaks {VERSION})")
    if n_tensors > MAX_TENSORS:
        raise FrameError(f"declared tensor count {n_tensors} exceeds the frame cap "
                         f"{MAX_TENSORS}")
    if meta_len > MAX_META_BYTES:
        raise FrameError(f"declared metadata length {meta_len} exceeds {MAX_META_BYTES} bytes")
    pos = _HEADER.size
    entries = []
    for i in range(n_tensors):
        if pos + _ENTRY.size > len(buf):
            raise FrameError(f"truncated tensor table at entry {i}")
        code, ndim, _res, offset, nbytes = _ENTRY.unpack_from(buf, pos)
        pos += _ENTRY.size
        if code >= len(_DTYPE_NAMES):
            raise FrameError(f"unknown dtype code {code} in entry {i}")
        if ndim > MAX_NDIM:
            raise FrameError(f"ndim {ndim} exceeds the frame cap {MAX_NDIM} in entry {i}")
        if pos + ndim * _DIM.size > len(buf):
            raise FrameError(f"truncated shape dims in entry {i}")
        shape = tuple(_DIM.unpack_from(buf, pos + k * _DIM.size)[0] for k in range(ndim))
        pos += ndim * _DIM.size
        entries.append((code, shape, offset, nbytes))
    if pos + meta_len > len(buf):
        raise FrameError(f"truncated metadata section: declared {meta_len} bytes, "
                         f"{len(buf) - pos} remain")
    try:
        meta = json.loads(bytes(buf[pos:pos + meta_len]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"frame metadata is not valid JSON: {e}")
    if not isinstance(meta, dict):
        raise FrameError(f"frame metadata must be a JSON object, got {type(meta).__name__}")
    if meta_only:
        return meta, []
    payload_start = pos + meta_len
    actual_payload = len(buf) - payload_start
    if payload_len != actual_payload:
        raise FrameError(f"payload length mismatch: header declares {payload_len} bytes, "
                         f"frame carries {actual_payload}")
    tensors: List[Any] = []
    for i, (code, shape, offset, nbytes) in enumerate(entries):
        # bounds before any tensor is made: a lying offset / nbytes must
        # never read past the buffer
        if offset + nbytes > payload_len:
            raise FrameError(f"tensor {i} spans [{offset}, {offset + nbytes}) past the "
                             f"{payload_len}-byte payload")
        name = _DTYPE_NAMES[code]
        itemsize = 2 if name == "bfloat16" else np.dtype(name).itemsize
        count = 1
        for dim in shape:
            count *= dim
        if count * itemsize != nbytes:
            raise FrameError(f"tensor {i} dtype/shape mismatch: shape {shape} x {name} needs "
                             f"{count * itemsize} bytes, entry declares {nbytes}")
        if name == "bfloat16":
            with warnings.catch_warnings():   # a read-only buffer: the view is never written
                warnings.simplefilter("ignore", UserWarning)
                arr = (torch.frombuffer(buf, dtype=torch.bfloat16, count=count,
                                        offset=payload_start + offset) if count
                       else torch.empty((0,), dtype=torch.bfloat16)).reshape(shape)
        else:
            arr = np.frombuffer(buf, dtype=np.dtype(name), count=count,
                                offset=payload_start + offset).reshape(shape)
        tensors.append(arr)
    _record("decode", path, len(buf), time.perf_counter() - t0)
    return meta, tensors


def tree_skeleton(tree: Any) -> Tuple[Dict[str, Any], List[Any]]:
    """(JSON-able skeleton, leaves) for a tree of dict / list / tuple
    containers; each leaf is replaced by its index into the leaf list."""
    leaves: List[Any] = []

    def enc(x: Any) -> Dict[str, Any]:
        if isinstance(x, tuple):
            return {"T": "tuple", "items": [enc(i) for i in x]}
        if isinstance(x, list):
            return {"T": "list", "items": [enc(i) for i in x]}
        if isinstance(x, dict):
            keys = list(x.keys())
            if not all(isinstance(k, str) for k in keys):
                raise FrameError("tree skeleton requires string dict keys")
            return {"T": "dict", "keys": keys, "items": [enc(x[k]) for k in keys]}
        leaves.append(x)
        return {"T": "leaf", "i": len(leaves) - 1}

    return enc(tree), leaves


def tree_unskeleton(skel: Any, leaves: Sequence[Any]) -> Any:
    """Rebuild the tree from ``tree_skeleton`` output; a malformed skeleton
    raises FrameError."""

    def dec(s: Any) -> Any:
        if not isinstance(s, dict) or "T" not in s:
            raise FrameError("malformed tree skeleton node")
        t = s["T"]
        if t == "leaf":
            i = s.get("i")
            if not isinstance(i, int) or not 0 <= i < len(leaves):
                raise FrameError(f"tree skeleton leaf {i!r} out of range")
            return leaves[i]
        if t == "tuple":
            return tuple(dec(i) for i in s.get("items", []))
        if t == "list":
            return [dec(i) for i in s.get("items", [])]
        if t == "dict":
            keys = s.get("keys", [])
            items = s.get("items", [])
            if len(keys) != len(items):
                raise FrameError("tree skeleton dict keys/items mismatch")
            return {k: dec(v) for k, v in zip(keys, items)}
        raise FrameError(f"unknown tree skeleton node type {t!r}")

    return dec(skel)


__all__ = ["FrameError", "MAGIC", "VERSION", "decode_frame", "encode_frame",
           "encode_frame_parts", "frame_stats", "tree_skeleton", "tree_unskeleton"]
