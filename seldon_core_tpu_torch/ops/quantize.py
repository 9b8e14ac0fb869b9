"""Int8 weight-only quantization for serving.

Port of ``seldon_core_tpu/ops/quantize.py``. Decode at small batch is bound
by the bytes of weights it streams; storing each projection as int8 halves
them against bf16. The scheme is the JAX package's: symmetric
per-output-channel int8, ``scale = max|w| / 127`` over every dim but the
last (1 where the channel is all zeros), so ``w ~= q * scale``. Leaves of
fewer than two dims (the norm weights) stay float.

What changes with the framework: the JAX package dequantizes inside the
jitted forward and lets XLA fuse the convert and multiply into the
consuming matmul, so the weights stream from device memory as int8. Eager
PyTorch has no such fusion: ``x @ (q.to(bf16) * scale)`` would write and
re-read a bf16 copy of every weight at every step. ``quantized_matmul``
therefore goes through ``ops/int8_matmul.py``: its W8A16 GEMM kernel on a
card (the port of the TPU kernel ``ops/pallas_int8.py``, which computes
exactly this function), its plain PyTorch version on the CPU.
"""

from __future__ import annotations

import torch
from torch import nn

from seldon_core_tpu_torch.ops.int8_matmul import int8_dense


class QuantizedTensor(nn.Module):
    """int8 values ``q`` [..., C] + float32 per-channel ``scale`` [C]
    (broadcast over the last dim); ``orig_dtype`` is the dtype
    dequantization restores. A module, so that ``q`` and ``scale`` are
    buffers of the model that holds it: they move with ``.to()`` and
    appear in ``state_dict()`` as ``<name>.q`` / ``<name>.scale``."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, orig_dtype: torch.dtype):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.orig_dtype = orig_dtype

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def extra_repr(self) -> str:
        return f"shape={tuple(self.q.shape)}, orig_dtype={self.orig_dtype}"


def _scale_and_round_(x: torch.Tensor, qmax: int) -> torch.Tensor:
    """In place on a float32 tensor: ``x <- clip(round(x / scale))``.
    Returns ``scale`` [C]. ``torch.round`` rounds half to even, as
    ``jnp.round`` does, so the codes are bit-equal to the JAX package's.
    max|x| is taken as max(max x, -min x): exact, and no |x| temporary the
    size of the leaf."""
    dims = tuple(range(x.dim() - 1))
    amax = torch.maximum(x.amax(dim=dims), x.amin(dim=dims).neg())
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    x.div_(scale).round_().clamp_(-qmax - 1, qmax)
    return scale


def quantize_array(w: torch.Tensor, bits: int = 8) -> QuantizedTensor:
    """Symmetric per-last-dim-channel quantization of one float tensor."""
    x = w.to(torch.float32, copy=True)
    scale = _scale_and_round_(x, 2 ** (bits - 1) - 1)
    return QuantizedTensor(x.to(torch.int8), scale, w.dtype)


@torch.no_grad()
def quantize_into_(t: QuantizedTensor, w: torch.Tensor) -> None:
    """Fill ``t`` with the quantization of float32 ``w`` stored in
    ``t.orig_dtype``: the same codes as ``quantize_array(w.to(orig_dtype))``.
    ``w`` is scratch and is overwritten, so a leaf costs one float32 copy of
    itself and no more (the streamed 7B init quantizes leaf by leaf)."""
    if t.orig_dtype != torch.float32:
        w.copy_(w.to(t.orig_dtype))        # the storage rounding
    t.scale.copy_(_scale_and_round_(w, 127))
    t.q.copy_(w)                           # integral values: the cast is exact


def dequantize_array(t: QuantizedTensor, dtype=None) -> torch.Tensor:
    """``q * scale`` in ``dtype`` (default ``t.orig_dtype``), both operands
    cast first, as the JAX package does."""
    dtype = dtype or t.orig_dtype
    return t.q.to(dtype) * t.scale.to(dtype)


def _is_quantizable(leaf) -> bool:
    """Float tensors of two or more dims; 1-D leaves (norm weights) and
    integer leaves stay as they are."""
    return (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and leaf.dim() >= 2)


def quantized_matmul(x: torch.Tensor, t: QuantizedTensor, out_dtype=None) -> torch.Tensor:
    """``x @ (q * scale)`` with float32 accumulation, in ``out_dtype``
    (default ``t.orig_dtype``); x: [..., K], t: a [K, N] weight. CPU tensors
    take the plain version; CUDA tensors launch the int8 GEMM kernel
    (``ops/int8_matmul.py``), or raise."""
    return int8_dense(x, t, out_dtype or t.orig_dtype)


__all__ = ["QuantizedTensor", "dequantize_array", "quantize_array", "quantize_into_",
           "quantized_matmul"]
