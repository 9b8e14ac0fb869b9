"""Fused residual-add + RMSNorm: a CUDA C++ kernel for Hopper, and its plain
PyTorch version.

Replaces the TPU kernel ``seldon_core_tpu/ops/fused_norm.py``
(``fused_residual_rmsnorm``, Pallas body ``_kernel``). Each transformer block
runs ``x = x + h`` followed by ``rms_norm(x)``; unfused, the activation makes
two round trips through device memory. The kernel (``csrc/fused_norm.cu``)
reads x, h and the weight once and writes the residual sum and the normed
activation once, in one launch.

At the served shapes ([8, 4096] at decode, [128, 4096] and [256, 4096] at
prefill) the call is bound by its latency, not by its bytes: the launch
after the previous kernel, one round trip to memory, the reduction across
a row, and on the host its enqueue (the served decode step is host-bound).
So one CTA takes one row, its threads hold the row in registers
(``_launch_plan``, fitted to ``chip_smoke.py --k2-sweep``; a row wider
than one CTA holds is walked in chunks), and the wrapper allocates once and
passes the launch's integers as one cached C array.
``fused_residual_rmsnorm_emulated`` walks the kernel's order of sums on the
CPU for the tests.

Numerics contract (as the JAX package's): the residual add happens in the
model dtype (float32 add, rounded once to the model dtype — bit-equal to
PyTorch's own add), the norm in float32 over the added value, divided by
the true ``d``, the weight multiply in float32, the result cast back to the
model dtype. ``y`` is therefore bit-equal to the plain version; ``o``
differs only by the reduction order of the mean, within one bf16 ulp.

Training: under autograd the call is a ``torch.autograd.Function`` whose
forward is the same launch and whose backward is one explicit float32
formula in plain PyTorch (``residual_rmsnorm_backward``), the same code on
the CPU and on the card. The JAX package has no backward kernel to port:
off the TPU ``jax.grad`` differentiates ``residual_rmsnorm_ref``. Without
it the kernel's outputs would carry no ``grad_fn``, and a training step
would stop at every layer's norm without an error.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from seldon_core_tpu_torch.ops import _build, launches


def residual_rmsnorm_ref(x: torch.Tensor, h: torch.Tensor, weight: torch.Tensor,
                         eps: float):
    """Plain version: (y, rms_norm(y, weight, eps)) with y = x + h — the op
    chain of the unfused TransformerBlock path."""
    y = x + h
    y32 = y.float()
    norm = y32 * torch.rsqrt(torch.mean(y32 * y32, dim=-1, keepdim=True) + eps)
    return y, (norm * weight).to(y.dtype)


# The kernel's limits (csrc/fused_norm.cu): 16-byte vectors a thread
# holds in a chunk, threads a CTA, the widest row.
SLOTS = (1, 2, 4)
MAX_THREADS = 512
MAX_D = 1 << 30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=None)
def _launch_plan(d: int, vec: int, plan=None):
    """(threads, slots, chunks) of one launch for rows of ``d`` values in
    16-byte vectors of ``vec``: ``plan`` = (threads, slots) as given, or
    the fewest slots that hold the row in one chunk within 256 threads
    (within 512 if four slots do not), threads a multiple of 32; a row
    wider than 512 threads x 4 slots takes chunks of that. Fitted to
    ``chip_smoke.py --k2-sweep`` on an H100 (``PERF.md`` §6): at d = 4096
    in bf16, 256 threads x 2 slots. Raises on a plan the kernel does not
    take."""
    if not 0 < d <= MAX_D:
        raise ValueError(f"fused_residual_rmsnorm: d = {d} outside 1..{MAX_D}")
    nvec = -(-d // vec)
    if plan is None:
        plan = next(((threads, slots) for cap in (256, MAX_THREADS) for slots in SLOTS
                     if (threads := 32 * -(-nvec // (32 * slots))) <= cap),
                    (MAX_THREADS, SLOTS[-1]))
    threads, slots = plan
    if threads % 32 or not 32 <= threads <= MAX_THREADS or slots not in SLOTS:
        raise ValueError(f"fused_residual_rmsnorm: plan {plan} is not (a multiple of 32 up "
                         f"to {MAX_THREADS} threads, {SLOTS} slots)")
    return threads, slots, -(-nvec // (threads * slots))


def _xor_tree(lanes: torch.Tensor) -> torch.Tensor:
    """Lane 0 of a warp's xor-shuffle sum over the last dim (32 lanes):
    lane l adds lane l ^ m for m = 16, 8, 4, 2, 1, each add rounded."""
    for m in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., torch.arange(32) ^ m]
    return lanes[..., 0]


def fused_residual_rmsnorm_emulated(x: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                                    eps: float, plan=None, *, fault: str | None = None):
    """The kernel's walk on the CPU, for the tests (nothing on the served
    path calls it): (y, o) in x's dtype, for x, h [..., d]. ``plan`` =
    (threads, slots) as ``_launch_plan`` takes it. Each row's y = x + h is
    rounded to x's dtype; its columns are 16-byte vectors of ``vec``
    values, and slot i of thread t in chunk k holds vector (k * slots + i)
    * threads + t. Each thread sums y * y in float32 in chunk, slot, then
    element order (rounding each product and each sum); each warp adds its
    lanes by the xor tree (16, 8, 4, 2, 1); the CTA adds its warps' sums by
    the same tree (zeros past the last warp) and divides by the true d.
    ``fault`` seeds what a wrong reduction would do: "warp" normalises each
    warp's columns by its own warp's sum (no merge across warps),
    "last_chunk" keeps only the last chunk's sum (a chunk loop that
    restarts it)."""
    d = x.shape[-1]
    vec = 16 // x.element_size()
    threads, slots, chunks = _launch_plan(d, vec, None if plan is None else tuple(plan))
    y = (x.float() + h.float()).to(x.dtype)
    y32 = y.float().reshape(-1, d)
    rows = y32.shape[0]
    sq = torch.zeros(rows, chunks * slots * threads * vec)
    sq[:, :d] = y32 * y32
    held = sq.reshape(rows, chunks, slots, threads, vec)
    ss = torch.zeros(rows, threads)
    for k in range(chunks):
        if fault == "last_chunk":
            ss = torch.zeros(rows, threads)
        for i in range(slots):
            for e in range(vec):
                ss = ss + held[:, k, i, :, e]
    warps = _xor_tree(ss.reshape(rows, threads // 32, 32))
    padded = torch.zeros(rows, 32)
    padded[:, :warps.shape[-1]] = warps
    total = _xor_tree(padded)
    if fault == "warp":   # each warp normalises its own columns by its own sum
        warp_of = (torch.arange(d) // vec) % threads // 32
        denom = warps[:, warp_of] / d
    else:
        denom = (total / d)[:, None]
    inv = torch.rsqrt(denom + torch.tensor(eps, dtype=torch.float32))
    o = ((y32 * inv) * w.float()).to(x.dtype)
    return y, o.reshape(x.shape)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point of ``csrc/fused_norm.cu``, built on first use."""
    fn = _build.load_library("fused_norm").fused_residual_rmsnorm
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _launch_params(rows: int, d: int, x_dtype, w_dtype, plan):
    """The entry point's int parameters for one shape, dtype pair and plan,
    as a C array: (rows, d, x dtype, w dtype, threads, slots, chunks).
    Built once and passed by address, since a forward makes the same call
    once per layer and each ctypes argument costs host time. Returns (the
    array, its address): the cache keeps it alive."""
    threads, slots, chunks = _launch_plan(d, 16 // x_dtype.itemsize, plan)
    params = (ctypes.c_int * 7)(rows, d, _DTYPE_CODES[x_dtype], _DTYPE_CODES[w_dtype], threads,
                                slots, chunks)
    return params, ctypes.addressof(params)


def _kernel(x, h, weight, y, o, eps, plan=None):
    """One launch into ``y`` and ``o`` with ``plan`` = (threads, slots), by
    default ``_launch_plan``'s: no checks, no count. The served path
    reaches this only through ``fused_residual_rmsnorm``; ``chip_smoke.py
    --k2-sweep`` and the card tests call it at other plans."""
    d = x.shape[-1]
    _, params = _launch_params(x.numel() // d, d, x.dtype, weight.dtype, plan)
    _build.launch(_entry(), x.device, x.data_ptr(), h.data_ptr(), weight.data_ptr(),
                  y.data_ptr(), o.data_ptr(), eps, params)


def _forward(x: torch.Tensor, h: torch.Tensor, weight: torch.Tensor, eps: float):
    """(y, normed): the plain version for CPU tensors, one kernel launch
    (counted) for CUDA tensors, which are checked first."""
    d = x.shape[-1]
    if h.shape != x.shape or tuple(weight.shape) != (d,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, h {tuple(h.shape)}, "
                         f"weight {tuple(weight.shape)}")
    dev = x.device
    if dev.type == "cpu":
        return residual_rmsnorm_ref(x, h, weight, eps)
    if dev.type != "cuda":
        raise ValueError(f"fused_residual_rmsnorm: unsupported device {dev}")
    if h.device != dev or weight.device != dev:
        raise ValueError("fused_residual_rmsnorm: x, h and weight must share a device")
    if x.dtype not in _DTYPE_CODES or h.dtype != x.dtype or weight.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_residual_rmsnorm: dtypes x={x.dtype} h={h.dtype} "
                        f"weight={weight.dtype} not supported")
    if not (x.is_contiguous() and h.is_contiguous() and weight.is_contiguous()):
        raise ValueError("fused_residual_rmsnorm: x, h and weight must be contiguous")
    y, o = x.new_empty((2, *x.shape)).unbind(0)
    if x.numel() == 0:
        return y, o
    _kernel(x, h, weight, y, o, eps)
    launches.count(fused_residual_rmsnorm)
    return y, o


def residual_rmsnorm_backward(y: torch.Tensor, weight: torch.Tensor, rstd: torch.Tensor,
                              d_y, d_o):
    """The gradient of (y, o) = (x + h, rms_norm(x + h, weight, eps)), in
    float32, from what the forward keeps: ``y`` [..., d], the weight [d] and
    ``rstd`` [..., 1] = rsqrt(mean(y * y) + eps) in float32. With n = y *
    rstd and g = d_o * weight: d_x = d_h = d_y + rstd * (g - n * mean(g *
    n)), d_weight = the sum of d_o * n over the rows. Returns (d_x in y's
    dtype, d_weight in float32); a cotangent that is None counts as zero."""
    n = y.float() * rstd
    d_x = torch.zeros_like(n) if d_y is None else d_y.float()
    d_w = None
    if d_o is not None:
        do32 = d_o.float()
        g = do32 * weight.float()
        d_x = d_x + rstd * (g - n * (g * n).mean(dim=-1, keepdim=True))
        d_w = (do32 * n).reshape(-1, n.shape[-1]).sum(dim=0)
    return d_x.to(y.dtype), d_w


class _Differentiable(torch.autograd.Function):
    """``fused_residual_rmsnorm`` under autograd: the forward is the
    kernel (the plain version for CPU tensors), the backward
    ``residual_rmsnorm_backward`` in plain PyTorch on either device. The
    JAX package defines no backward for its Pallas kernel: ``jax.grad``
    differentiates ``residual_rmsnorm_ref`` off the TPU, which the explicit
    float32 formula follows."""

    @staticmethod
    def forward(ctx, x, h, weight, eps):
        y, o = _forward(x, h, weight, eps)
        y32 = y.float()
        rstd = torch.rsqrt(torch.mean(y32 * y32, dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(y, weight, rstd)
        return y, o

    @staticmethod
    def backward(ctx, d_y, d_o):
        y, weight, rstd = ctx.saved_tensors
        d_x, d_w = residual_rmsnorm_backward(y, weight, rstd, d_y, d_o)
        d_w = d_w.to(weight.dtype) if d_w is not None and ctx.needs_input_grad[2] else None
        return d_x, d_x, d_w, None


def fused_residual_rmsnorm(x: torch.Tensor, h: torch.Tensor, weight: torch.Tensor,
                           eps: float):
    """x, h: [..., d] activations; weight: [d]. Returns (y, normed) =
    (x + h, rms_norm(x + h, weight, eps)), both in x.dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (one launch, no synchronisation), or raise. ``y``
    and ``normed`` are views of one allocation. Where autograd records
    (grad mode on and an input requiring a gradient: training) the call
    goes through ``_Differentiable``, whose forward is the same launch and
    whose backward is ``residual_rmsnorm_backward``; otherwise (serving,
    a CUDA-graph capture under ``no_grad``) nothing else runs."""
    if torch.is_grad_enabled() and (x.requires_grad or h.requires_grad
                                    or weight.requires_grad):
        return _Differentiable.apply(x, h, weight, eps)
    return _forward(x, h, weight, eps)


fused_residual_rmsnorm.launches = 0


__all__ = ["fused_residual_rmsnorm", "fused_residual_rmsnorm_emulated", "residual_rmsnorm_backward",
           "residual_rmsnorm_ref"]
