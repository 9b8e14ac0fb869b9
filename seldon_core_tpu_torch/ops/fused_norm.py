"""Fused residual-add + RMSNorm: a Triton kernel for Hopper, and its plain
PyTorch version.

Replaces the TPU kernel ``seldon_core_tpu/ops/fused_norm.py``
(``fused_residual_rmsnorm``, Pallas body ``_kernel``). Each transformer block
runs ``x = x + h`` followed by ``rms_norm(x)``; unfused, the activation makes
two round trips through device memory. This kernel reads x and h once and
writes the residual sum and the normed activation once.

What bounds it on the card: bytes. Per row it moves 2 reads + 2 writes of
``d`` model-dtype values (plus the ``d`` weights, which stay in L2) and does
~5 flops per element — far below the ~295 flops/byte at which an H100 stops
being memory bound. Design: one program per row, ``BLOCK = next_pow2(d)``
with a masked tail, the whole row held in registers, so each element is
loaded and stored exactly once; the sum of squares is a float32 in-register
reduction divided by the real ``d``.

Numerics contract (as the JAX package's): the residual add happens in the
model dtype (float32 add, rounded once to the model dtype — bit-equal to
PyTorch's own add), the norm in float32 over the added value, the weight
multiply in float32, the result cast back to the model dtype. ``y`` is
therefore bit-equal to the plain version; ``o`` differs only by the
reduction order of the mean, within one bf16 ulp.
"""

from __future__ import annotations

import torch

tl = None  # triton.language, bound by _compiled() at first launch


def residual_rmsnorm_ref(x: torch.Tensor, h: torch.Tensor, weight: torch.Tensor,
                         eps: float):
    """Plain version: (y, rms_norm(y, weight, eps)) with y = x + h — the op
    chain of the unfused TransformerBlock path."""
    y = x + h
    y32 = y.float()
    norm = y32 * torch.rsqrt(torch.mean(y32 * y32, dim=-1, keepdim=True) + eps)
    return y, (norm * weight).to(y.dtype)


def _residual_rmsnorm_kernel(x_ptr, h_ptr, w_ptr, y_ptr, o_ptr, d, eps,
                             BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < d
    base = row * d
    x = tl.load(x_ptr + base + cols, mask=mask, other=0.0)
    h = tl.load(h_ptr + base + cols, mask=mask, other=0.0)
    # residual add in the model dtype: float32 add, one rounding
    y = (x.to(tl.float32) + h.to(tl.float32)).to(x.dtype)
    tl.store(y_ptr + base + cols, y, mask=mask)
    y32 = y.to(tl.float32)
    # sum / d, not a mean over BLOCK: the masked tail adds zeros only
    ms = tl.sum(y32 * y32, axis=0) / d
    normed = y32 * (1.0 / tl.sqrt(ms + eps))
    w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    tl.store(o_ptr + base + cols, (normed * w).to(x.dtype), mask=mask)


_KERNEL = None


def _compiled():
    """The jitted kernel, built at first launch (triton is imported here,
    never at module import, so the CPU tests can import this module)."""
    global _KERNEL, tl
    if _KERNEL is None:
        import triton
        import triton.language

        tl = triton.language
        _KERNEL = triton.jit(_residual_rmsnorm_kernel)
    return _KERNEL


_FLOATS = (torch.bfloat16, torch.float16, torch.float32)


def fused_residual_rmsnorm(x: torch.Tensor, h: torch.Tensor, weight: torch.Tensor,
                           eps: float):
    """x, h: [..., d] activations; weight: [d]. Returns (y, normed) =
    (x + h, rms_norm(x + h, weight, eps)), both in x.dtype.

    CPU tensors take the plain version; CUDA tensors launch the Triton
    kernel (one program per row) on the current stream, or raise."""
    d = x.shape[-1]
    if h.shape != x.shape or tuple(weight.shape) != (d,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, h {tuple(h.shape)}, "
                         f"weight {tuple(weight.shape)}")
    if x.device.type == "cpu":
        return residual_rmsnorm_ref(x, h, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_rmsnorm: unsupported device {x.device}")
    if h.device != x.device or weight.device != x.device:
        raise ValueError("fused_residual_rmsnorm: x, h and weight must share a device")
    if x.dtype not in _FLOATS or h.dtype != x.dtype or weight.dtype not in _FLOATS:
        raise TypeError(f"fused_residual_rmsnorm: dtypes x={x.dtype} h={h.dtype} "
                        f"weight={weight.dtype} not supported")
    if not (x.is_contiguous() and h.is_contiguous() and weight.is_contiguous()):
        raise ValueError("fused_residual_rmsnorm: x, h and weight must be contiguous")
    y = torch.empty_like(x)
    o = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y, o
    block = 1 << max(d - 1, 0).bit_length()
    num_warps = 4 if block <= 1024 else 8 if block <= 4096 else 16
    with torch.cuda.device(x.device):
        _compiled()[(rows,)](x, h, weight, y, o, d, float(eps),
                             BLOCK=block, num_warps=num_warps)
    fused_residual_rmsnorm.launches += 1
    return y, o


fused_residual_rmsnorm.launches = 0

__all__ = ["fused_residual_rmsnorm", "residual_rmsnorm_ref"]
