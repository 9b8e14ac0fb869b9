"""Paged-attention decode read: a CUDA C++ kernel for Hopper, and its plain
PyTorch version.

Replaces the TPU kernel ``seldon_core_tpu/ops/paged_attention.py``
(``paged_attention``, Pallas body ``_kernel``), both of its branches: the
bf16 pool (the (k, v, pos) triple) and the int8 pool (the (k_q, k_scale,
v_q, v_scale, pos) 5-tuple of ``kv_cache_dtype="int8"``). The paged KV pool
(``models/transformer.py`` ``init_paged_kv_caches`` + the batcher's block
tables) bills device memory for pages actually written; the plain read
gathers every sequence's whole logical view back into a contiguous buffer
first. The kernel (``csrc/paged_attention.cu``) instead streams only the
pages each block table names, once, with 16-byte loads, and accumulates the
masked softmax online in float32; an int8 pool is read as int8 and scaled
once per key (``s_k * (q . k_q)``, ``p * s_v``).

What bounds it on the card: bytes — the K and V pages of every sequence,
read once (a few flops per byte); the int8 pool moves about half of them.
The kernel splits each (sequence, kv head) over ``S`` CTAs, each a
contiguous range of key chunks of the pages the row walks, and the CTA
that finishes last merges the ``S`` partials in the same launch; ``S``
comes from ``_split_plan``, a function of shapes only (the host never
reads a position, so the step stays free of host syncs). The source note
in the ``.cu`` file says how the design serves that.

Numerics: masking uses the pooled position rows exactly like the dense path
(masked logits are ``finfo(float32).min``, never -inf), GQA maps query head
j to kv head ``j // (h / kvh)``. The kernel is NOT bit-identical to the
plain version (float32 throughout vs. the model-dtype einsum chain, and a
different reduction order; the plain version dequantizes an int8 pool in the
model dtype, as the JAX package's gather does); the port's paged == dense
bit-exactness on the CPU is carried by the plain version, which is the dense
read on gathered bytes.

Partial mode (``paged_attention_partial``): a pool of one 'seq' rank of a
sharded model (``models/sharded.py``) holds pages ``offset, offset +
stride, ...`` of each sequence (round robin over the ranks), and its table
names only those. The same kernel, launched with the rank's (stride,
offset), stops its walk after the rank's pages up to the query's page and
writes, in place of the bf16 output, each (row, head)'s float32
unnormalised accumulator with its running max and sum: the state
``parallel/collectives.softmax_merge`` combines over the ranks. A rank
holding no page of a row writes max = -FLT_MAX, sum 0, and merges to
nothing.
"""

from __future__ import annotations

import ctypes
import math
import threading
from functools import lru_cache
from typing import Dict, Optional, Tuple

import torch

from seldon_core_tpu_torch.ops import launches

_HEAD_DIMS = (32, 64, 128)
# keys per chunk, the unit of the split: the largest power of two up to
# this that divides the page size
CHUNK_KEYS = 16
# the split plan aims at this many CTAs per launch (fitted to
# ``chip_smoke.py --k1-sweep`` on an H100; see ``_split_plan``)
TARGET_CTAS = 256


def paged_attention_ref(q, cache, block_tables, positions):
    """Plain version: gather the logical view through the block table
    (``gather_paged_view``, the same gather the prefill read uses; it
    dequantizes an int8 pool in q's dtype) and run the dense masked-softmax
    read. q: [b, 1, h, hd]; cache: the paged bf16 triple or int8 5-tuple;
    block_tables: [b, n_pages]; positions: [b, 1]. Returns [b, 1, h, hd] in
    q.dtype."""
    from seldon_core_tpu_torch.models.transformer import (gather_paged_view,
                                                          masked_attention)

    k_all, v_all, pos_view = gather_paged_view(cache, block_tables, q.dtype)
    mask = pos_view[:, None, :] <= positions[:, :, None]
    return masked_attention(q, k_all, v_all, mask)


def paged_attention_partial_ref(q, cache, block_tables, positions, stride: int = 1,
                                offset: int = 0):
    """Plain version of the partial mode: the rank's logical view gathered
    through its table (``gather_paged_view``), the masked float32 logits
    (``attention_logits``) and their (max [b, h, 1], sum [b, h, 1], acc [b,
    1, h, hd]) by ``collectives.softmax_partial``, all float32. It reads
    every table entry (``stride`` and ``offset`` only let the kernel stop
    early: entries past the query's page hold later positions or PAD_POS,
    which the mask drops)."""
    from seldon_core_tpu_torch.models.transformer import attention_logits, gather_paged_view
    from seldon_core_tpu_torch.parallel.collectives import softmax_partial

    del stride, offset
    k_all, v_all, pos_view = gather_paged_view(cache, block_tables, q.dtype)
    logits, v_rep = attention_logits(q, k_all, v_all, pos_view[:, None, :] <= positions[:, :, None])
    return softmax_partial(logits, v_rep)


def _chunk_keys(ps: int) -> int:
    """Keys per chunk: the largest power of two <= CHUNK_KEYS dividing ps."""
    return math.gcd(ps, CHUNK_KEYS)


def _head_tile(G: int) -> int:
    """Query heads per CTA: the least power of two >= G, at most 8 (a
    larger G takes ceil(G / 8) head tiles, each reading K/V once)."""
    return min(8, 1 << (G - 1).bit_length())


@lru_cache(maxsize=256)
def _split_plan(b: int, kvh: int, G: int, n_pages: int, ps: int, hd: int,
                quantized: bool) -> int:
    """S, the CTAs each (sequence, kv head, head tile) is split over: a pure
    function of shapes the host knows, never of the positions. The kernel
    spreads each row's walked chunks evenly over its S CTAs whatever the
    context, so S is sized to fill the card: about TARGET_CTAS CTAs in all,
    at least 1, at most the chunks of ``n_pages`` pages. Each CTA keeps
    many loads in flight, so one CTA per (sequence, kv head) is enough
    once there are that many: the sweep found S = 1 fastest, or within 2 %
    of it, at b = 8 and 32 kv heads, and S = 4 at 8 kv heads. ``hd`` and
    ``quantized`` do not move the pick at the measured shapes."""
    pairs = b * kvh * -(-G // _head_tile(G))
    n_chunks = n_pages * (ps // _chunk_keys(ps))
    return max(1, min(-(-TARGET_CTAS // pairs), n_chunks))


def _kernel_fn(quantized: bool):
    fns = _kernel_fn.fns
    if quantized not in fns:
        from seldon_core_tpu_torch.ops._build import load_library

        lib = load_library("paged_attention")
        n_ptrs = 9 if quantized else 7
        fn = (lib.paged_attention_decode_int8 if quantized
              else lib.paged_attention_decode_bf16)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        fns[quantized] = fn
    return fns[quantized]


_kernel_fn.fns = {}

# Arrival counters of split launches, per (device index, stream): zeroed
# when made, and zero again after every launch (the last CTA of a pair
# resets its own). One buffer per stream, so launches on two streams never
# share a counter. Grown (a new zeroed buffer) when b * kvh * head tiles
# outgrows it; never written by the host otherwise.
_counters: Dict[Tuple[int, int], torch.Tensor] = {}
_counters_lock = threading.Lock()


def _counter_buffer(device: torch.device, stream: int, pairs: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < pairs:
        with _counters_lock:
            buf = _counters.get(key)
            if buf is None or buf.numel() < pairs:
                buf = torch.zeros(max(pairs, 2 * (0 if buf is None else buf.numel())),
                                  dtype=torch.int32, device=device)
                _counters[key] = buf
    return buf


def _check(cache, q, block_tables, positions):
    """Raise on what the kernel does not take; returns (ps, kvh, n_pages)."""
    b, _, h, hd = q.shape
    quantized = len(cache) == 5
    k_pool, v_pool, pos_pool = (cache[0], cache[2], cache[4]) if quantized else cache
    n_pool, ps, kvh, hd_k = k_pool.shape
    n_pages = block_tables.shape[1] if block_tables.dim() == 2 else -1
    scales_ok = (not quantized or tuple(cache[1].shape) == tuple(cache[3].shape)
                 == (n_pool, ps, kvh))
    if (tuple(v_pool.shape) != tuple(k_pool.shape) or hd_k != hd or not scales_ok
            or tuple(pos_pool.shape) != (n_pool, ps)
            or tuple(block_tables.shape) != (b, n_pages) or n_pages < 1
            or positions.numel() != b or kvh < 1 or h % kvh):
        raise ValueError(
            f"paged_attention: inconsistent shapes q={tuple(q.shape)} "
            f"cache={[tuple(t.shape) for t in cache]} "
            f"block_tables={tuple(block_tables.shape)} positions={tuple(positions.shape)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head_dim {hd} not in {_HEAD_DIMS}")
    kv_dtype = torch.int8 if quantized else torch.bfloat16
    if q.dtype != torch.bfloat16 or k_pool.dtype != kv_dtype or v_pool.dtype != kv_dtype:
        raise TypeError(f"paged_attention kernel takes bf16 q and {kv_dtype} K/V, got "
                        f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if quantized and (cache[1].dtype != torch.float32 or cache[3].dtype != torch.float32):
        raise TypeError("paged_attention kernel takes float32 K/V scales")
    if pos_pool.dtype != torch.int32 or block_tables.dtype != torch.int32:
        raise TypeError("paged_attention kernel takes int32 pos_pool and block_tables")
    for t in (q, *cache, block_tables, positions):
        if t.device != q.device:
            raise ValueError("paged_attention: every input must be on q's device")
        if not t.is_contiguous():
            raise ValueError("paged_attention: inputs must be contiguous")
    # rows are read as 16-byte vectors: a row is a multiple of 16 bytes for
    # every supported head dim, so the pools' bases must be aligned
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_attention kernel: the K and V pools must start on a "
                         "16-byte boundary (it reads rows as 16-byte vectors)")
    return ps, kvh, n_pages


def paged_attention(q, cache, block_tables, positions, *, _splits: Optional[int] = None):
    """q: [b, 1, h, hd]; cache: a paged pool — the bf16 triple ([pages,
    page_size, kvh, hd] K/V + [pages, page_size] int32 positions) or the
    int8 5-tuple (int8 K/V, float32 [pages, page_size, kvh] scales after
    each, positions last); block_tables: [b, n_pages] int32; positions:
    [b, 1] query positions. Returns [b, 1, h, hd] in q.dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (one launch, no synchronisation, no read of a
    device value), or raise. ``launches`` counts the bf16 kernel's
    launches, ``launches_int8`` the int8 kernel's. ``_splits`` forces the
    kernel's split count S (1 .. the chunks of ``n_pages`` pages) in place
    of ``_split_plan``'s; tests and the sweep use it.

    Precondition of the kernel (not of the plain version): it walks each
    row's table only up to the query position's page, index
    ``positions // page_size``, where the plain version walks all
    ``n_pages``. The two agree when every page at table index j holds only
    positions in ``[j * page_size, (j + 1) * page_size)`` or ``PAD_POS``,
    which the batcher keeps by resetting a page's positions when it hands
    the page out, or when a row names one page throughout (a free slot's
    all-TRASH row: fewer copies of the same keys give the same softmax).
    A table that puts a page holding earlier positions at a later index
    (a page shared at another offset) breaks it, and would attend
    differently on the card only."""
    if len(cache) not in (3, 5):
        raise ValueError(
            f"paged_attention: cache must be the bf16 (k, v, pos) triple or the int8 "
            f"(k_q, k_scale, v_q, v_scale, pos) 5-tuple, got a {len(cache)}-tuple")
    b, s, h, hd = q.shape
    if s != 1:
        raise ValueError(f"paged_attention is the decode (s=1) read, got s={s}")
    if q.device.type == "cpu":
        return paged_attention_ref(q, cache, block_tables, positions)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    out = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
    _launch(q, cache, block_tables, positions, _splits, 1, 0, out, None, None)
    launches.count(paged_attention, "launches_int8" if len(cache) == 5 else "launches")
    return out.view(b, 1, h, hd)


def paged_attention_partial(q, cache, block_tables, positions, stride: int = 1, offset: int = 0,
                            *, _splits: Optional[int] = None):
    """The partial mode (module docstring): ``paged_attention``'s inputs,
    ``block_tables`` a 'seq' rank's table whose entry i is its sequence's
    page ``offset + i * stride``. Returns (max [b, h, 1], sum [b, h, 1], acc
    [b, 1, h, hd]), float32, ``collectives.softmax_partial``'s form. CPU
    tensors take ``paged_attention_partial_ref``; CUDA tensors launch the
    kernel (its own counters ``launches`` and ``launches_int8``) or
    raise."""
    if len(cache) not in (3, 5):
        raise ValueError(f"paged_attention_partial: cache must be a 3- or 5-tuple, got "
                         f"{len(cache)}")
    b, s, h, hd = q.shape
    if s != 1:
        raise ValueError(f"paged_attention_partial is the decode (s=1) read, got s={s}")
    stride, offset = int(stride), int(offset)
    if stride < 1 or not 0 <= offset < stride:
        raise ValueError(f"paged_attention_partial: stride={stride}, offset={offset}: need "
                         f"stride >= 1 and 0 <= offset < stride")
    if q.device.type == "cpu":
        return paged_attention_partial_ref(q, cache, block_tables, positions, stride, offset)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_partial: unsupported device {q.device}")
    acc = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    ml = torch.empty((b, h, 2), dtype=torch.float32, device=q.device)
    _launch(q, cache, block_tables, positions, _splits, stride, offset, None, acc, ml)
    launches.count(paged_attention_partial, "launches_int8" if len(cache) == 5 else "launches")
    return ml[..., 0:1], ml[..., 1:2], acc.view(b, 1, h, hd)


def _launch(q, cache, block_tables, positions, _splits, stride, offset, out, part_acc, part_ml):
    """One launch of the kernel on the current stream: the bf16 ``out``, or
    the partial mode's ``part_acc`` / ``part_ml``."""
    b, _, h, hd = q.shape
    ps, kvh, n_pages = _check(cache, q, block_tables, positions)
    quantized = len(cache) == 5
    G = h // kvh
    chunk = _chunk_keys(ps)
    if _splits is None:
        splits = _split_plan(b, kvh, G, n_pages, ps, hd, quantized)
    else:
        splits = int(_splits)
        if not 1 <= splits <= min(n_pages * (ps // chunk), 65535):
            raise ValueError(f"paged_attention: _splits={_splits} outside 1 .. "
                             f"{n_pages * (ps // chunk)} chunks")
    qpos = positions.reshape(b)
    if qpos.dtype != torch.int32:
        qpos = qpos.to(torch.int32)
    from seldon_core_tpu_torch.ops._build import launch

    tile = _head_tile(G)
    ws = counters = None
    if splits > 1:
        pairs = b * kvh * -(-G // tile)
        ws = torch.empty(pairs * splits * tile * (hd + 2), dtype=torch.float32,
                         device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = _counter_buffer(q.device, stream, pairs)
    ptr = (lambda t: None if t is None else t.data_ptr())
    launch(_kernel_fn(quantized), q.device, q.data_ptr(), *(t.data_ptr() for t in cache),
           block_tables.data_ptr(), qpos.data_ptr(), ptr(out), b, h, kvh, hd, ps, n_pages,
           float(hd ** -0.5), splits, chunk, tile, ptr(ws), ptr(counters), stride, offset,
           ptr(part_acc), ptr(part_ml))


paged_attention.launches = 0
paged_attention.launches_int8 = 0
paged_attention_partial.launches = 0
paged_attention_partial.launches_int8 = 0

__all__ = ["paged_attention", "paged_attention_partial", "paged_attention_partial_ref",
           "paged_attention_ref"]
