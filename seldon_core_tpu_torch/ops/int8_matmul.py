"""Int8 weight-only matmul (W8A16 GEMM): two CUDA C++ kernels for Hopper,
and their one plain PyTorch version.

Replaces the TPU kernel ``seldon_core_tpu/ops/pallas_int8.py``
(``int8_matmul``, Pallas body ``_kernel``): ``x @ (q * scale)`` with the
weight tile crossing device memory as int8 and dequantized next to the
matrix unit, float32 accumulation. In the port it is the serving path of
``quantize="int8"``: every projection of the transformer and its lm_head go
through ``ops/quantize.quantized_matmul`` -> ``int8_dense`` -> here.

Two routes, picked by ``_uses_wgmma`` from the shapes and alignment alone:

* decode, M < 64 (``csrc/int8_matmul.cu``): bound by bytes, the K x N int8
  weight read once. One launch per product: a CTA streams a strip of 128 or
  256 weight columns over one split of K through a ring of 16 KB stages,
  dequantizes in registers and multiplies on the tensor cores (``mma.sync``);
  the splits of a strip form a thread block cluster and sum their float32
  partials through distributed shared memory in rank order, so the call
  allocates nothing but its output and gives the same bits every time.
  ``_decode_plan`` picks the width and the split from the shapes, fitted to
  ``chip_smoke.py --k4-decode-sweep``. It also takes what TMA cannot
  address: N % 16 != 0, K % 8 != 0, or bases not 16-byte aligned.
* prefill, M >= ``PREFILL_MIN_M`` (``csrc/int8_matmul_wgmma.cu``): a TMA
  ring feeding ``wgmma``, the int8 tile converted to bf16 in shared memory.
  Bound by bytes at M = 128, by operations at M = 256. ``_wgmma_plan``
  picks the tile's width (128 x 128, or 128 x 256, which brings in half the
  x bytes per weight byte) and the split of K, by a model of the kernel's
  time fitted to measurements on the card.

The source notes in ``csrc/`` say how each design serves its regime, and
why scaling in the epilogue computes the TPU kernel's function.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from seldon_core_tpu_torch.ops import launches

# The decode kernel (csrc/int8_matmul.cu): strip widths, weight bytes per
# stage (a stage is 16384 / width rows of K), the most splits of K (the
# cluster size), and the columns of a warp's slab.
DEC_WIDTHS = (128, 256)
DEC_STAGE_BYTES = 16384
DEC_MAX_SPLITS = 8
DEC_SLAB = 128
# The decode plan's time model (``_decode_plan``), fitted to its runs on an
# NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py --k4-decode-sweep): device
# time of one 16 KB stage of an SM's CTA while every SM streams, by strip
# width (the longer runs stream a little faster); a CTA's own start and
# end (the ring's first fill, the epilogue); the cost of one more split
# (its partial through distributed shared memory); and the share of the
# SMs that a grid of clusters fills one CTA apiece (a cluster stays in one
# GPC, so near the SM count some SMs get two).
_DEC_STEP_US = {128: 0.66, 256: 0.64}
_DEC_CTA_US = 1.0
_DEC_SPLIT_US = 0.1
_DEC_CLUSTER_SMS = 0.8
# the prefill kernel's tile rows, widths and depth (csrc/int8_matmul_wgmma.cu:
# BM, BN, BK), and the smallest M it takes: the 64 rows of one wgmma
WG_BM, WG_BNS, WG_BK = 128, (128, 256), 64
PREFILL_MIN_M = 64
# The prefill kernel's time model (``_wgmma_plan``), from its runs on an
# NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py --k4-sweep): device time of
# one 64-deep step of one CTA, by tile width; the rate at which a split's
# float32 partials are written and read back; at most this many splits.
_STEP_US = {128: 0.8, 256: 1.35}
_PARTIAL_BYTES_PER_US = 3.5e6
_MAX_SPLITS = 16
_OUT_DTYPES = (torch.bfloat16, torch.float32)


def int8_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    out_dtype=None) -> torch.Tensor:
    """Plain version: ``x.float() @ (q.float() * scale)`` cast to
    ``out_dtype`` (default ``x.dtype``) — the JAX package's expression."""
    out_dtype = out_dtype or x.dtype
    return (x.float() @ (q.float() * scale.float())).to(out_dtype)


def _decode_rows(m: int) -> int:
    """Rows of x per CTA of the decode kernel: one 8-row mma fragment up to
    M = 8, two (16 rows) above; larger M takes more tiles of 16."""
    return 8 if m <= 8 else 16


@functools.lru_cache(maxsize=None)
def _decode_plan(m: int, n: int, k: int, sms: int):
    """(strip width, splits, stages per split) for the decode kernel's
    [m, k] x [k, n] product on a card of ``sms`` SMs: the plan of least
    modelled time. Every stage moves the same 16 KB of weight, and CTAs on
    one SM share its stream, so the busiest SM runs ceil(CTAs / SMs filled)
    CTAs, each ``_DEC_CTA_US`` plus ``per`` stages at ``_DEC_STEP_US`` (a
    grid of clusters fills ``_DEC_CLUSTER_SMS`` of the SMs one apiece);
    every split past the first adds ``_DEC_SPLIT_US``. Never an empty
    split, at most DEC_MAX_SPLITS (one cluster); on a tie the fewer CTAs,
    then the fewer splits. Cached: a decode step asks for the same four
    shapes 225 times."""
    best = None
    for bn in DEC_WIDTHS:
        steps = max(-(-k // (DEC_STAGE_BYTES // bn)), 1)
        tiles = -(-m // _decode_rows(m)) * -(-n // bn)
        for s in range(1, min(steps, DEC_MAX_SPLITS) + 1):
            per = -(-steps // s)
            if -(-steps // per) != s:   # the same cut as a smaller split
                continue
            filled = sms if s == 1 else int(_DEC_CLUSTER_SMS * sms)
            us = (-(-tiles * s // filled) * (_DEC_CTA_US + per * _DEC_STEP_US[bn])
                  + (s - 1) * _DEC_SPLIT_US)
            key = (us, tiles * s, s, bn, per)
            best = key if best is None or key < best else best
    return best[3], best[2], best[4]


def _frag_columns() -> torch.Tensor:
    """The column of a 128-column slab that the decode kernel's mma
    fragment f holds at row r, at register slot 16 * f + r: the byte order
    of a lane's 16-byte loads (csrc/int8_matmul.cu, the column interleave)."""
    return torch.tensor([16 * (r % 8) + 2 * f + r // 8 for f in range(8) for r in range(16)])


def int8_matmul_emulated(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, plan, *,
                         interleave: bool = True) -> torch.Tensor:
    """The decode kernel's walk on the CPU, for the tests (nothing on the
    served path calls it): float32 [M, N]. ``plan`` = (strip width, splits,
    stages per split). For each tile of rows and strip of columns, each
    split (a CTA) runs its stages in order; in a stage, warp w of a slab
    adds the 16-deep slice w of the stage to its accumulators, which hold
    the slab's columns in fragment order (``_frag_columns``). The epilogue
    puts them back in column order, sums the slab's warps in order, then
    the cluster's splits in rank order, and scales. ``interleave`` False
    leaves the column order as the registers hold it (a seeded fault)."""
    bn, splits, per = plan
    bk = DEC_STAGE_BYTES // bn
    warps = bk // 16
    m, k = x.shape
    n = q.shape[1]
    mt = _decode_rows(m)
    kp = max(splits * per * bk, k)
    xp = torch.zeros(-(-m // mt) * mt, kp)
    xp[:m, :k] = x.float()
    qp = torch.zeros(kp, -(-n // bn) * bn)
    qp[:k, :n] = q.float()
    slots = _frag_columns()
    out = torch.empty(m, n)
    for m0 in range(0, m, mt):
        for n0 in range(0, n, bn):
            ranks = []
            for split in range(splits):
                cta = torch.zeros(mt, bn)
                for c0 in range(0, bn, DEC_SLAB):
                    cols = n0 + c0 + slots
                    warp_sums = []
                    for w in range(warps):
                        acc = torch.zeros(mt, DEC_SLAB)
                        for st in range(split * per, min((split + 1) * per, kp // bk)):
                            rows = slice(st * bk + 16 * w, st * bk + 16 * w + 16)
                            acc += xp[m0:m0 + mt, rows] @ qp[rows][:, cols]
                        natural = torch.empty_like(acc)
                        if interleave:
                            natural[:, slots] = acc
                        else:
                            natural = acc
                        warp_sums.append(natural)
                    part = warp_sums[0]
                    for ws in warp_sums[1:]:
                        part = part + ws
                    cta[:, c0:c0 + DEC_SLAB] = part
                ranks.append(cta)
            total = ranks[0]
            for r in ranks[1:]:
                total = total + r
            hi_m, hi_n = min(m0 + mt, m), min(n0 + bn, n)
            out[m0:hi_m, n0:hi_n] = (total[:hi_m - m0, :hi_n - n0]
                                     * scale[n0:hi_n].float())
    return out


@functools.lru_cache(maxsize=None)
def _wgmma_plan(m: int, n: int, k: int, sms: int):
    """(tile width, splits, 64-deep steps per split) for the prefill
    kernel's [m, k] x [k, n] product on a card of ``sms`` SMs: the plan of
    least modelled time. A CTA holds its SM alone (150-225 KB of shared
    memory), so the busiest SM runs ceil(CTAs / sms) CTAs one after the
    other, each ``per`` steps of ``_STEP_US``; every split past the first
    adds its [m, n] float32 partial, written and read back. Never an empty
    split; the narrower tile and the fewer splits on a tie. Cached: a
    prefill forward asks for the same seven shapes 225 times."""
    steps = max(-(-k // WG_BK), 1)
    best = None
    for bn in WG_BNS:
        tiles = -(-m // WG_BM) * -(-n // bn)
        for s in range(1, min(steps, _MAX_SPLITS) + 1):
            per = -(-steps // s)
            if -(-steps // per) != s:   # the same cut as a smaller split
                continue
            us = (-(-tiles * s // sms) * per * _STEP_US[bn]
                  + (s > 1) * s * m * n * 8 / _PARTIAL_BYTES_PER_US)
            if best is None or us < best[0]:
                best = (us, bn, s, per)
    return best[1:]


def _uses_wgmma(m: int, n: int, k: int, x_ptr: int, q_ptr: int) -> bool:
    """The route of an [m, k] x [k, n] product whose x and q start at
    ``x_ptr`` and ``q_ptr``: the prefill kernel for M >= PREFILL_MIN_M where
    TMA can address both operands (16-byte row strides: K % 8 == 0 and
    N % 16 == 0; 16-byte aligned bases), the decode kernel otherwise."""
    return (m >= PREFILL_MIN_M and k > 0 and k % 8 == 0 and n % 16 == 0
            and x_ptr % 16 == 0 and q_ptr % 16 == 0)


@functools.lru_cache(maxsize=None)
def _entry(lib: str, name: str, n_ptrs: int, n_ints: int):
    """The C entry point ``name`` of ``csrc/<lib>.cu``, built on first use:
    (``n_ptrs`` pointers, ``n_ints`` ints, stream)."""
    from seldon_core_tpu_torch.ops._build import load_library

    fn = getattr(load_library(lib), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _decode_kernel(x, q, scale, out, plan=None) -> torch.Tensor:
    """The decode kernel into ``out``, at any M, with ``plan`` = (strip
    width, splits, stages per split), by default ``_decode_plan``'s: one
    launch, nothing allocated, no checks, no count. The served path reaches
    it only through ``int8_matmul``; ``chip_smoke.py`` also times it at
    prefill shapes beside the prefill kernel."""
    from seldon_core_tpu_torch.ops._build import launch, sm_count

    m, k = x.shape
    n = q.shape[1]
    bn, splits, per = plan or _decode_plan(m, n, k, sm_count(x.device.index))
    launch(_entry("int8_matmul", "int8_matmul_bf16", 4, 7), x.device, x.data_ptr(),
           q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, k,
           int(out.dtype == torch.float32), bn, splits, per)
    return out


def _wgmma_kernel(x, q, scale, out, plan=None) -> torch.Tensor:
    """The prefill kernel (TMA + wgmma, split-K) into ``out`` with ``plan``
    = (tile width, splits, steps per split), by default ``_wgmma_plan``'s:
    no checks, no count. With several splits, each writes a float32
    partial that a second kernel sums."""
    from seldon_core_tpu_torch.ops._build import launch, sm_count

    m, k = x.shape
    n = q.shape[1]
    bn, splits, per = plan or _wgmma_plan(m, n, k, sm_count(x.device.index))
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    launch(_entry("int8_matmul_wgmma", "int8_matmul_wgmma_bf16", 5, 7), x.device, x.data_ptr(),
           q.data_ptr(), scale.data_ptr(), out.data_ptr(),
           None if partial is None else partial.data_ptr(),
           m, n, k, int(out.dtype == torch.float32), splits, per, bn)
    return out


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """x [M, K] float; q [K, N] int8; scale [N] float32 -> [M, N] in
    ``out_dtype`` (default ``x.dtype``): ``x @ (q * scale)`` with float32
    accumulation.

    CPU tensors take the plain version; CUDA tensors launch one of the two
    kernels on the current stream (no synchronisation), or raise. Both take
    bf16 ``x`` and write bf16 or float32: the lm_head's ``x.float() @ W`` is
    bf16 in, float32 out, since ``x.float()`` of a bf16 ``x`` is exact.
    ``launches`` counts every launch, ``launches_wgmma`` those of the
    prefill kernel."""
    if (x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0]
            or tuple(scale.shape) != (q.shape[1],)):
        raise ValueError(f"int8_matmul: shapes x={tuple(x.shape)} q={tuple(q.shape)} "
                         f"scale={tuple(scale.shape)}: expected [M, K], [K, N], [N]")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_matmul_ref(x, q, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul kernel takes bf16 x, int8 q, float32 scale; got "
                        f"{x.dtype}/{q.dtype}/{scale.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int8_matmul kernel writes bf16 or float32, not {out_dtype}")
    for t in (q, scale):
        if t.device != x.device:
            raise ValueError("int8_matmul: x, q and scale must share a device")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_matmul: x, q and scale must be contiguous")
    m, k = x.shape
    n = q.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    if _uses_wgmma(m, n, k, x.data_ptr(), q.data_ptr()):
        _wgmma_kernel(x, q, scale, out)
        launches.count(int8_matmul, "launches_wgmma")
    else:
        _decode_kernel(x, q, scale, out)
    launches.count(int8_matmul)
    return out


int8_matmul.launches = 0
int8_matmul.launches_wgmma = 0


def int8_matmul_backward(dy: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                         x_dtype) -> torch.Tensor:
    """The input gradient of ``x @ (q * scale)``: ``dy @ (q * scale)^T``,
    the weight dequantized in ``dy``'s dtype, cast to ``x_dtype``. Plain
    PyTorch on either device: the JAX package has no backward kernel to
    port (``jax.grad`` differentiates the dequantized product)."""
    w = q.to(dy.dtype) * scale.to(dy.dtype)
    return (dy @ w.t()).to(x_dtype)


class _Differentiable(torch.autograd.Function):
    """``int8_matmul`` under autograd: the forward is the launch (the plain
    version for CPU tensors), the backward ``int8_matmul_backward`` in
    plain PyTorch, the same code on both devices. The codes and scales are
    not trained: a gradient for them raises."""

    @staticmethod
    def forward(ctx, x, q, scale, out_dtype):
        ctx.save_for_backward(q, scale)
        ctx.x_dtype = x.dtype
        return int8_matmul(x, q, scale, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        q, scale = ctx.saved_tensors
        return int8_matmul_backward(dy, q, scale, ctx.x_dtype), None, None, None


def int8_dense(x: torch.Tensor, qt, out_dtype=None) -> torch.Tensor:
    """Apply a quantized [K, N] weight (``ops/quantize.QuantizedTensor``:
    ``q``, ``scale``, ``orig_dtype``) to activations [..., K]; leading dims
    are flattened around the kernel. Output dtype defaults to the weight's
    ``orig_dtype``, as in the JAX package.

    Where autograd records (grad mode on and ``x`` requiring a gradient: a
    saliency explanation) the product goes through ``_Differentiable``,
    whose forward is the same launch and whose backward gives ``x`` its
    gradient; otherwise (serving, a CUDA-graph capture under ``no_grad``)
    nothing else runs."""
    out_dtype = out_dtype or qt.orig_dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if torch.is_grad_enabled() and qt.scale.requires_grad:
        raise ValueError("int8_dense: the int8 codes and scales are not trained; only x takes "
                         "a gradient")
    if torch.is_grad_enabled() and x.requires_grad:
        out = _Differentiable.apply(x2, qt.q, qt.scale, out_dtype)
    else:
        out = int8_matmul(x2, qt.q, qt.scale, out_dtype)
    return out.reshape(*lead, out.shape[-1])


__all__ = ["int8_dense", "int8_matmul", "int8_matmul_backward", "int8_matmul_ref"]
