"""Paged-attention decode read: a CUDA C++ kernel for Hopper, and its plain
PyTorch version.

Replaces the TPU kernel ``seldon_core_tpu/ops/paged_attention.py``
(``paged_attention``, Pallas body ``_kernel``). The paged KV pool
(``models/transformer.py`` ``init_paged_kv_caches`` + the batcher's block
tables) bills device memory for pages actually written; the plain read
gathers every sequence's whole logical view back into a contiguous buffer
first. The kernel (``csrc/paged_attention.cu``) instead streams only the
pages each block table names, once, and accumulates the masked softmax
online in float32.

What bounds it on the card: bytes — the K and V pages of every sequence,
read once (a few flops per byte). The source note in the ``.cu`` file says
how the design serves that.

Numerics: masking uses the pooled position rows exactly like the dense path
(masked logits are ``finfo(float32).min``, never -inf), GQA maps query head
j to kv head ``j // (h / kvh)``. The kernel is NOT bit-identical to the
plain version (float32 throughout vs. the model-dtype einsum chain, and a
different reduction order); the port's paged == dense bit-exactness on the
CPU is carried by the plain version, which is the dense read on gathered
bytes.
"""

from __future__ import annotations

import ctypes

import torch

_HEAD_DIMS = (32, 64, 128)


def paged_attention_ref(q, cache, block_tables, positions):
    """Plain version: gather the logical view through the block table
    (``gather_paged_view``, the same gather the prefill read uses) and run
    the dense masked-softmax read. q: [b, 1, h, hd]; cache: the paged
    (k_pool, v_pool, pos_pool) triple; block_tables: [b, n_pages];
    positions: [b, 1]. Returns [b, 1, h, hd] in q.dtype."""
    from seldon_core_tpu_torch.models.transformer import (gather_paged_view,
                                                          masked_attention)

    k_all, v_all, pos_view = gather_paged_view(cache, block_tables, q.dtype)
    mask = pos_view[:, None, :] <= positions[:, :, None]
    return masked_attention(q, k_all, v_all, mask)


def _kernel_fn():
    lib_fn = _kernel_fn.fn
    if lib_fn is None:
        from seldon_core_tpu_torch.ops._build import load_library

        lib_fn = load_library("paged_attention").paged_attention_decode_bf16
        lib_fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        lib_fn.restype = ctypes.c_int
        _kernel_fn.fn = lib_fn
    return lib_fn


_kernel_fn.fn = None


def paged_attention(q, cache, block_tables, positions):
    """q: [b, 1, h, hd]; cache: paged pool triple ([pages, page_size, kvh,
    hd] K/V + [pages, page_size] int32 positions); block_tables: [b,
    n_pages] int32; positions: [b, 1] query positions. Returns [b, 1, h,
    hd] in q.dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (no synchronisation), or raise.

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
    if len(cache) == 5:
        raise NotImplementedError(
            "the int8 paged pool (5-tuple) arrives with the int8-KV slice")
    k_pool, v_pool, pos_pool = cache
    b, s, h, hd = q.shape
    if s != 1:
        raise ValueError(f"paged_attention is the decode (s=1) read, got s={s}")
    if q.device.type == "cpu":
        return paged_attention_ref(q, cache, block_tables, positions)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    n_pool, ps, kvh, hd_k = k_pool.shape
    n_pages = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if (tuple(v_pool.shape) != tuple(k_pool.shape) or hd_k != hd
            or tuple(pos_pool.shape) != (n_pool, ps)
            or tuple(block_tables.shape) != (b, n_pages) or n_pages < 1
            or positions.numel() != b or kvh < 1 or h % kvh):
        raise ValueError(
            f"paged_attention: inconsistent shapes q={tuple(q.shape)} "
            f"k_pool={tuple(k_pool.shape)} v_pool={tuple(v_pool.shape)} "
            f"pos_pool={tuple(pos_pool.shape)} block_tables={tuple(block_tables.shape)} "
            f"positions={tuple(positions.shape)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head_dim {hd} not in {_HEAD_DIMS}")
    if q.dtype != torch.bfloat16 or k_pool.dtype != torch.bfloat16 \
            or v_pool.dtype != torch.bfloat16:
        raise TypeError(f"paged_attention kernel takes bf16 q/K/V, got "
                        f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if pos_pool.dtype != torch.int32 or block_tables.dtype != torch.int32:
        raise TypeError("paged_attention kernel takes int32 pos_pool and block_tables")
    for t in (q, k_pool, v_pool, pos_pool, block_tables, positions):
        if t.device != q.device:
            raise ValueError("paged_attention: every input must be on q's device")
        if not t.is_contiguous():
            raise ValueError("paged_attention: inputs must be contiguous")
    qpos = positions.reshape(b)
    if qpos.dtype != torch.int32:
        qpos = qpos.to(torch.int32)
    out = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pos_pool.data_ptr(),
                block_tables.data_ptr(), qpos.data_ptr(), out.data_ptr(),
                b, h, kvh, hd, ps, n_pages, float(hd ** -0.5), stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {rc}")
    paged_attention.launches += 1
    return out.view(b, 1, h, hd)


paged_attention.launches = 0

__all__ = ["paged_attention", "paged_attention_ref"]
