"""Read and write the JAX package's msgpack checkpoints without flax.

``JAXServer`` reads ``params.msgpack``, written by
``export_checkpoint(use_orbax=False)`` with ``flax.serialization.to_bytes``
(``servers/jaxserver.py``). The card's machine has neither flax nor the
``msgpack`` package, so the port keeps its own reader and writer of the
msgpack subset ``to_bytes`` emits:

- maps with str keys, arrays (lists), nil, bools, ints, floats, str, bin;
- ext type 1, an ndarray, and ext type 3, a numpy scalar: each holds a
  packed ``(shape, dtype name, C-order bytes)`` triple.

Leaves come back as numpy arrays — except ``"bfloat16"`` leaves, which
numpy cannot hold without ml_dtypes: they are read as uint16 and returned
as ``torch.bfloat16`` tensors. flax splits a leaf over 2**30 bytes into a
``__msgpack_chunked_array__`` map; reading one raises, naming the leaf, as
does writing a leaf that large. An orbax ``params/`` directory cannot be
read here either (``load_params`` raises, naming the format).
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.contracts.payload import SeldonError

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization's chunking threshold
EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        t = self.unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if t in sized:
            fmt, kind = sized[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(fixext[t])))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in scalars:
            return self.unpack(scalars[t])
        raise ValueError(f"msgpack type byte 0x{t:02x} is not supported")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _ext(code: int, data: bytes):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"msgpack ext type {code} is not one flax writes for arrays")
    r = _Reader(data)
    shape, name, buf = r.value()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        arr = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        t = torch.from_numpy(arr.copy()).view(torch.bfloat16)
        return t.reshape(()) if code == EXT_NPSCALAR else t
    arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()
    return arr[()] if code == EXT_NPSCALAR else arr


def _check_chunks(tree: Any, path: str = "") -> None:
    if isinstance(tree, dict):
        if CHUNKED_KEY in tree:
            raise SeldonError(f"checkpoint leaf {path or '<root>'!r} is chunked (a leaf over "
                              f"{MAX_CHUNK_SIZE} bytes, split by flax): not supported by the "
                              f"port's reader", status_code=500)
        for k, v in tree.items():
            _check_chunks(v, f"{path}.{k}" if path else str(k))


def loads(data: bytes) -> Any:
    """Decode flax ``to_bytes`` output into nested dicts of numpy arrays
    (bfloat16 leaves as torch tensors)."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the msgpack value")
    _check_chunks(tree)
    return tree


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix: Tuple[int, int], b8, b16: int, b32: int) -> None:
    base, limit = fix
    if n < limit and base is not None:
        out.append(base | n)
    elif n < 256 and b8 is not None:
        out += bytes((b8, n))
    elif n < 1 << 16:
        out += bytes((b16,)) + struct.pack(">H", n)
    else:
        out += bytes((b32,)) + struct.pack(">I", n)


def _array_payload(arr, path: str) -> bytes:
    """The packed (shape, dtype name, C-order bytes) triple of a leaf."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            name, buf = "bfloat16", t.view(torch.uint16).numpy().tobytes()
        else:
            a = t.numpy()
            name, buf = a.dtype.name, a.tobytes("C")
        shape = list(t.shape)
    else:
        a = np.asarray(arr)
        if a.dtype.hasobject:
            raise ValueError(f"{path}: object arrays cannot be serialized")
        name, buf, shape = a.dtype.name, a.tobytes("C"), list(a.shape)
    if len(buf) > MAX_CHUNK_SIZE:
        raise ValueError(f"{path}: a leaf over {MAX_CHUNK_SIZE} bytes would need flax's "
                         f"chunked layout, which the port's writer does not produce")
    out = bytearray()
    _pack(out, [shape, name, buf], path)
    return bytes(out)


def _pack(out: bytearray, v: Any, path: str) -> None:
    if v is None:
        out.append(0xC0)
    elif isinstance(v, bool):
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int):
        if 0 <= v <= 0x7F:
            out.append(v)
        elif -32 <= v < 0:
            out.append(v & 0xFF)
        elif 0 <= v < 1 << 64:
            out += b"\xcf" + struct.pack(">Q", v)
        else:
            out += b"\xd3" + struct.pack(">q", v)
    elif isinstance(v, float):
        out += b"\xcb" + struct.pack(">d", v)
    elif isinstance(v, str):
        b = v.encode()
        _pack_len(out, len(b), (0xA0, 32), 0xD9, 0xDA, 0xDB)
        out += b
    elif isinstance(v, (bytes, bytearray)):
        _pack_len(out, len(v), (None, 0), 0xC4, 0xC5, 0xC6)
        out += v
    elif isinstance(v, dict):
        _pack_len(out, len(v), (0x80, 16), None, 0xDE, 0xDF)
        for k, item in v.items():
            if not isinstance(k, str):
                raise ValueError(f"{path}: map keys must be str, got {type(k).__name__}")
            _pack(out, k, path)
            _pack(out, item, f"{path}.{k}" if path else k)
    elif isinstance(v, (list, tuple)):
        _pack_len(out, len(v), (0x90, 16), None, 0xDC, 0xDD)
        for i, item in enumerate(v):
            _pack(out, item, f"{path}[{i}]")
    elif isinstance(v, (np.ndarray, torch.Tensor, np.generic)):
        scalar = isinstance(v, np.generic)
        payload = _array_payload(np.asarray(v) if scalar else v, path)
        out.append(0xC9)
        out += struct.pack(">I", len(payload))
        out += struct.pack(">b", EXT_NPSCALAR if scalar else EXT_NDARRAY)
        out += payload
    else:
        raise ValueError(f"{path}: cannot serialize a {type(v).__name__}")


def dumps(tree: Any) -> bytes:
    """Encode nested dicts of arrays (numpy, numpy scalars or tensors;
    bfloat16 tensors as flax's "bfloat16" leaves) as flax ``to_bytes``
    does; ``flax.serialization.msgpack_restore`` reads the result."""
    out = bytearray()
    _pack(out, tree, "")
    return bytes(out)


def load_params(path: str) -> Dict[str, Any]:
    """The param tree of a checkpoint directory (``params.msgpack``); an
    orbax ``params/`` directory raises ``SeldonError`` naming the format."""
    orbax_dir = os.path.join(path, "params")
    msgpack_file = os.path.join(path, "params.msgpack")
    if os.path.exists(msgpack_file):
        with open(msgpack_file, "rb") as f:
            return loads(f.read())
    if os.path.isdir(orbax_dir):
        raise SeldonError(f"{orbax_dir} is an orbax checkpoint, which the port cannot read "
                          f"(no orbax on the card's machine): export it with "
                          f"export_checkpoint(..., use_orbax=False) to params.msgpack",
                          status_code=500)
    raise SeldonError(f"No params found under {path} (expected params.msgpack)",
                      status_code=500)


__all__ = ["dumps", "load_params", "loads"]
