"""The port's frame layer (``seldon_core_tpu_torch/codec/framing.py``) held
against ``seldon_core_tpu/codec/framing.py`` on the CPU:

- the same (metadata, numpy tensors) encode to the same bytes in both;
  torch tensors (bfloat16 among them) encode to the bytes of their numpy
  or ml_dtypes twins;
- frames encoded by JAX decode in the port to equal bits, and the other way
  round, for float32, int32, int8 and bfloat16 (a bf16 tensor decodes to a
  ``torch.bfloat16`` view); ``meta_only`` works on both, also on a frame
  whose payload was cut;
- malformed frames raise ``FrameError`` (400, MALFORMED_FRAME) in both;
- the tree skeleton is JAX's JSON, and round-trips;
- the codec's tallies count bytes per path and drain the time samples."""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

from seldon_core_tpu.codec import framing as jf
from seldon_core_tpu_torch.codec import framing as pf

DTYPES = ["float32", "int32", "int8", "bfloat16"]


def _np(dtype: str, shape=(3, 5), seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "bfloat16":
        return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    if dtype.startswith("int"):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, size=shape, dtype=dtype)
    return rng.standard_normal(shape).astype(dtype)


def _bits(x) -> np.ndarray:
    """Raw bytes of a numpy array or torch tensor."""
    if torch.is_tensor(x):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


META = {"kind": "KVHandoff", "job_id": 7, "note": "ünïcode", "events": []}


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_frame_decodes_in_port(dtype):
    arrs = [_np(dtype), _np(dtype, (0,), 1), _np(dtype, (), 2), _np("float32", (4,), 3)]
    meta, got = pf.decode_frame(jf.encode_frame(META, arrs, path="handoff"), path="handoff")
    assert meta == META
    for a, g in zip(arrs, got):
        assert tuple(g.shape) == a.shape
        assert np.array_equal(_bits(g), _bits(a))
    assert (got[0].dtype == torch.bfloat16) if dtype == "bfloat16" else got[0].dtype == dtype


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_frame_decodes_in_jax(dtype):
    arrs = [_np(dtype), _np(dtype, (2, 0, 3), 1), _np("int8", (7,), 4)]
    tensors = [torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
               if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a) for a in arrs]
    buf = pf.encode_frame(META, tensors, path="rest")
    assert buf == jf.encode_frame(META, arrs, path="rest")   # torch in, JAX's bytes out
    meta, got = jf.decode_frame(buf)
    assert meta == META
    for a, g in zip(arrs, got):
        assert g.dtype == a.dtype and g.shape == a.shape
        assert np.array_equal(_bits(g), _bits(a))


def test_numpy_encodings_are_byte_identical():
    arrs = [_np(d, seed=i) for i, d in enumerate(("float32", "int32", "int8", "float64",
                                                    "uint8", "int64"))]
    arrs.append(np.array([True, False]))
    assert pf.encode_frame(META, arrs) == jf.encode_frame(META, arrs)
    assert pf.encode_frame({}, []) == jf.encode_frame({}, [])


@pytest.mark.parametrize("encode", [jf.encode_frame, pf.encode_frame], ids=["jax", "port"])
def test_meta_only_survives_a_cut_payload(encode):
    buf = encode(META, [_np("float32", (64,))])
    for dec in (jf.decode_frame, pf.decode_frame):
        assert dec(buf[:-40], meta_only=True) == (META, [])
        with pytest.raises(jf.FrameError if dec is jf.decode_frame else pf.FrameError):
            dec(buf[:-40])


def _mutations():
    good = jf.encode_frame(META, [_np("float32")])
    lying = bytearray(good)
    # the first table entry's nbytes (u64 at header 24 + 12): claims more
    lying[36:44] = (10**6).to_bytes(8, "little")
    return {"short header": good[:10], "bad magic": b"XXXX" + good[4:],
            "bad version": good[:4] + b"\x09\x00" + good[6:],
            "payload mismatch": good + b"\x00", "lying nbytes": bytes(lying),
            "not json": good[:24 + 8 * 3 + 16] + b"{" * len(json.dumps(META).encode())
            + good[24 + 8 * 3 + 16 + len(json.dumps(META, separators=(",", ":")).encode()):],
            "not bytes": "a string"}


@pytest.mark.parametrize("name", list(_mutations()))
def test_malformed_frames_raise_in_both(name):
    buf = _mutations()[name]
    errs = []
    for dec, err in ((jf.decode_frame, jf.FrameError), (pf.decode_frame, pf.FrameError)):
        with pytest.raises(err) as ei:
            dec(buf)
        errs.append((ei.value.status_code, ei.value.reason))
    assert errs[0] == errs[1] == (400, "MALFORMED_FRAME")


def test_tree_skeleton_equals_jax():
    tree = [(1, 2, {"a": 3, "b": [4]}), (5,)]
    skel, leaves = pf.tree_skeleton(tree)
    assert (skel, leaves) == jf.tree_skeleton(tree)
    assert pf.tree_unskeleton(json.loads(json.dumps(skel)), leaves) == tree
    for bad in ({"T": "leaf", "i": 9}, {"T": "nope"}, [1], {"T": "dict", "keys": ["a"]}):
        with pytest.raises(pf.FrameError):
            pf.tree_unskeleton(bad, leaves)
    with pytest.raises(pf.FrameError):
        pf.tree_skeleton({1: 2})


def test_frame_stats_count_bytes_per_path():
    pf.frame_stats()  # drain
    before = pf.frame_stats(drain=False)["frame_bytes_total"].get("handoff", 0)
    buf = pf.encode_frame(META, [_np("int8")], path="handoff")
    pf.decode_frame(buf, path="handoff")
    st = pf.frame_stats()
    assert st["frame_bytes_total"]["handoff"] == before + 2 * len(buf)
    assert len(st["frame_encode_times_s"]) == 1 and len(st["frame_decode_times_s"]) == 1
    assert pf.frame_stats()["frame_encode_times_s"] == []
