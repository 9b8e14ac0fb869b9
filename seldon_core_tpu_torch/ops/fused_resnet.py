"""Folded-BN ResNet identity bottleneck chains: a CUDA C++ kernel for
Hopper, and its plain PyTorch version.

Replaces the TPU kernel ``seldon_core_tpu/ops/fused_resnet.py``
(``fused_identity_chain``, Pallas body ``_chain_kernel``). An identity
bottleneck block (every block of a ResNet stage but the first: stride 1, no
projection) computes, over NHWC bf16 activations,

    y1 = bf16(relu(x . w1 + b1))                1x1 reduce,  C -> F
    y2 = bf16(relu(conv3x3_SAME(y1) . w2 + b2)) 3x3,         F -> F
    x' = relu(bf16(y2 . w3 + b3) + x)           1x1 expand,  F -> C

with float32 accumulation of bf16 products, each float32 bias added before
the one rounding to bf16, and the residual added in bf16. A chain is its
blocks in turn with a bf16 hand-off between them. In the port it is the
serving path of the folded ResNet: ``models/resnet_infer.py``
``resnet_serve_forward`` runs every identity chain of the stages named in
``pallas_stages`` through here, and the folded ``ResNet`` module names all
of them.

The kernel (``csrc/fused_resnet_wgmma.cu``) runs each conv of a block as
one implicit GEMM over the whole batch's pixels, ``[B*H*W, channels]``:
128 pixel rows x 64, 128 or 256 columns per CTA, a TMA ring feeding
``wgmma``, the bias, relu and residual applied to its registers. The 3x3
conv reads y1 once per tap as a flat shift of the rows and zeroes the rows
whose tap leaves their image (the TPU kernel's seam and wrap masks for
stacked images). y1 and y2 cross device memory as bf16 workspaces,
allocated once per chain call; the bytes this adds bound it at 56x56 and
28x28, the products at 14x14 and 7x7. Three launches per block, one more
for each conv whose K range is split (float32 partials, then a reduce:
small batches); ``_k3_plan`` picks the widths and splits, and
``expected_launches`` counts the launches. ``gemm_chain_emulated`` repeats
its tiling, shifts and masks on the CPU for the tests. The activation
written between blocks is exactly the bf16 hand-off of the plain version.
The TPU kernel's ``group`` (images per grid program, sized for the TPU's
matrix unit) keeps its ``ValueError`` and has no other effect here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch
import torch.nn.functional as F

from seldon_core_tpu_torch.ops import launches


def _block_param_list(blocks: Sequence[dict]) -> List[torch.Tensor]:
    """Flatten per-block folded params into the kernel's operand order:
    (w1, b1, w2, b2, w3, b3) per block, shapes w1 (C, F), b1 (F,), w2
    (9F, F), b2 (F,), w3 (F, C), b3 (C,). w2 arrives as the (3, 3, F, F)
    HWIO kernel and is flattened tap-major — row ``(3*kh + kw)*F + ci`` —
    as a view of a contiguous tensor (no copy)."""
    out: List[torch.Tensor] = []
    for blk in blocks:
        f = blk["w1"].shape[1]
        if tuple(blk["w2"].shape[:2]) != (3, 3):
            raise ValueError(f"3x3 conv expected, got {tuple(blk['w2'].shape)}")
        out.extend([blk["w1"], blk["b1"], blk["w2"].reshape(9 * f, f), blk["b2"], blk["w3"],
                    blk["b3"]])
    return out


def _conv3x3_same(y: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """float32 3x3 SAME conv of NHWC ``y`` by the HWIO kernel ``w2`` as one
    im2col product: the zero-padded taps concatenated tap-major against w2
    flattened to (9F, F). A float32 matmul, so no TF32 on the card."""
    b, h, w, f = y.shape
    yp = F.pad(y, (0, 0, 1, 1, 1, 1))
    taps = [yp[:, kh:kh + h, kw:kw + w, :] for kh in range(3) for kw in range(3)]
    return torch.cat(taps, dim=-1) @ w2.reshape(9 * f, -1)


def identity_chain_ref(x: torch.Tensor, blocks: Sequence[dict]) -> torch.Tensor:
    """Plain version of the chain: float32 arithmetic on the bf16 values,
    rounded to ``x.dtype`` at the hand-offs the kernel rounds at (the JAX
    package's ``identity_chain_ref``)."""
    dtype = x.dtype
    for blk in blocks:
        y = torch.relu(x.float() @ blk["w1"].float() + blk["b1"].float()).to(dtype)
        y = torch.relu(_conv3x3_same(y.float(), blk["w2"].float())
                       + blk["b2"].float()).to(dtype)
        y = (y.float() @ blk["w3"].float() + blk["b3"].float()).to(dtype)
        x = torch.relu(x + y)
    return x


def folded_block_params(scope: dict) -> dict:
    """Map one folded ``BottleneckBlock_*`` param scope (flax names, HWIO
    kernels) to the kernel's dict: 1x1 kernels lose their two unit dims."""
    return {
        "w1": scope["Conv_0"]["kernel"].reshape(scope["Conv_0"]["kernel"].shape[-2:]),
        "b1": scope["Conv_0"]["bias"],
        "w2": scope["Conv_1"]["kernel"],
        "b2": scope["Conv_1"]["bias"],
        "w3": scope["Conv_2"]["kernel"].reshape(scope["Conv_2"]["kernel"].shape[-2:]),
        "b3": scope["Conv_2"]["bias"],
    }


# The kernel's tile (csrc/fused_resnet_wgmma.cu: BM, BK) and widths
GEMM_BM, GEMM_BK, GEMM_BNS = 128, 64, (64, 128, 256)
H100_SMS = 132
# The kernel's time model (``_conv_plan``), fitted to its runs on an
# NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py --k3-sweep): a 64-deep step
# of one CTA takes _STEP_US + _STEP_US_PER_COL * width, a CTA _CTA_US more
# (ring fill, epilogue); split partials are written and read back at
# _PARTIAL_BYTES_PER_US, plus _REDUCE_US for the reduce; no conv beats its
# operands and output crossing device memory at _BYTES_PER_US. At most
# _MAX_SPLITS splits.
_STEP_US, _STEP_US_PER_COL, _CTA_US = 0.3, 0.001, 1.0
_PARTIAL_BYTES_PER_US, _REDUCE_US = 3.0e6, 2.0
_BYTES_PER_US = 2.0e6
_MAX_SPLITS = 8


def _conv_dims(c: int, f: int):
    """(A width, N, 64-deep K steps) of a block's three convs: the 1x1
    reduce [M, C] x [C, F], the 3x3 [M, 9F] x [9F, F] read as 9 taps of y1
    [M, F], the 1x1 expand [M, F] x [F, C]."""
    return ((c, f, c // GEMM_BK), (f, f, 9 * f // GEMM_BK), (f, c, f // GEMM_BK))


def _conv_plan(m: int, ka: int, n: int, steps: int, resid: bool, sms: int):
    """(tile width, splits, steps per split) of least modelled time for one
    conv of ``m`` pixel rows, A width ``ka``, ``n`` output columns and
    ``steps`` K steps (``resid``: it reads the residual too). The busiest SM
    runs ceil(CTAs / sms) CTAs of ``per`` steps each; every split past the
    first adds its float32 partial, written and read back, and a reduce; the
    bytes floor clips it. Never an empty split; the narrower tile and the
    fewer splits on a tie. At the sweep's 24 convs it picks the fastest 20
    times, and is within 7 % of it at the other four."""
    best = None
    m_tiles = -(-m // GEMM_BM)
    floor = 2 * m * (ka + n * (1 + resid)) / _BYTES_PER_US
    for bn in GEMM_BNS:
        if n % bn:
            continue
        tiles = m_tiles * (n // bn)
        for s in range(1, min(steps, _MAX_SPLITS) + 1):
            per = -(-steps // s)
            if -(-steps // per) != s:   # the same cut as a smaller split
                continue
            us = -(-tiles * s // sms) * (per * (_STEP_US + _STEP_US_PER_COL * bn) + _CTA_US)
            if s > 1:
                us += s * m * n * 8 / _PARTIAL_BYTES_PER_US + _REDUCE_US
            us = max(us, floor)
            if best is None or us < best[0]:
                best = (us, bn, s, per)
    return best[1:]


@functools.lru_cache(maxsize=None)
def _k3_plan(b: int, h: int, w: int, c: int, f: int, sms: int = H100_SMS):
    """The kernel's plan of one identity block over a (b, h, w, c)
    activation with F = ``f`` on a card of ``sms`` SMs: three (tile width,
    splits, steps per split), one per conv. A pure function of shapes,
    fitted to ``chip_smoke.py --k3-sweep``. Cached: a forward asks for four
    shapes."""
    return tuple(_conv_plan(b * h * w, ka, n, steps, i == 2, sms)
                 for i, (ka, n, steps) in enumerate(_conv_dims(c, f)))


def expected_launches(b: int, h: int, w: int, c: int, f: int, n_blocks: int,
                      sms: int = H100_SMS):
    """The launches that one chain of ``n_blocks`` blocks adds to
    ``fused_identity_chain.launches`` on a card of ``sms`` SMs, from the
    plan: three per block, plus one reduce per conv whose K range is split."""
    return n_blocks * sum(1 + (splits > 1) for _, splits, _ in _k3_plan(b, h, w, c, f, sms))


def _tap_keep(b: int, h: int, w: int, col_mask: bool = True) -> torch.Tensor:
    """[b*h*w, 9] bool: tap (dh, dw), column 3 (dh + 1) + (dw + 1), of flat
    pixel p lies inside p's own image — the kernel's tap bits. Without
    ``col_mask`` only the rows are checked (a fault: columns wrap)."""
    p = torch.arange(b * h * w)
    row, col = (p // w) % h, p % w
    keep = []
    for dh in (-1, 0, 1):
        for dw in (-1, 0, 1):
            ok = (row + dh >= 0) & (row + dh < h)
            if col_mask:
                ok &= (col + dw >= 0) & (col + dw < w)
            keep.append(ok)
    return torch.stack(keep, dim=1)


def gemm_chain_emulated(x: torch.Tensor, blocks: Sequence[dict], *,
                        col_mask: bool = True) -> torch.Tensor:
    """The kernel's arithmetic on the CPU, for the tests: the batch's
    pixels flattened to M rows in 128-row tiles (the last one ragged); each
    conv's float32 sums of bf16 products, rounded once after the bias; the
    3x3 conv as 9 taps, each a flat shift of y1's rows by dh * W + dw with
    zeros past both ends (TMA's fill) and the rows whose tap leaves their
    image zeroed, summed tap after tap as the K loop runs. ``col_mask``
    False drops the wrap mask (a seeded fault)."""
    b, h, w, c = x.shape
    m = b * h * w
    mp = -(-m // GEMM_BM) * GEMM_BM
    dtype = x.dtype
    keep = F.pad(_tap_keep(b, h, w, col_mask), (0, 0, 0, mp - m), value=True)

    def tiles(a):   # [M, k] -> [tiles, 128, k] float32, zero rows past M
        return F.pad(a.float(), (0, 0, 0, mp - a.shape[0])).reshape(mp // GEMM_BM, GEMM_BM, -1)

    cur = x.reshape(m, c)
    for blk in blocks:
        f = blk["w1"].shape[1]
        y1 = torch.relu(tiles(cur) @ blk["w1"].float() + blk["b1"].float()).to(dtype)
        y1 = y1.reshape(mp, f)[:m]
        w2 = blk["w2"].float().reshape(9, f, f)
        acc = torch.zeros(mp // GEMM_BM, GEMM_BM, f)
        rows = torch.arange(mp)
        for tap in range(9):
            src = rows + (tap // 3 - 1) * w + (tap % 3 - 1)
            inside = (src >= 0) & (src < m) & keep[:, tap]
            a = torch.where(inside[:, None], y1[src.clamp(0, m - 1)].float(), 0.0)
            acc = acc + tiles(a) @ w2[tap]
        y2 = torch.relu(acc + blk["b2"].float()).to(dtype).reshape(mp, f)[:m]
        y = (tiles(y2) @ blk["w3"].float() + blk["b3"].float()).to(dtype).reshape(mp, c)[:m]
        cur = torch.relu(cur + y)
    return cur.reshape(b, h, w, c)


@functools.lru_cache(maxsize=None)
def _gemm_fn():
    """The entry point of ``csrc/fused_resnet_wgmma.cu``, built on first use:
    (stage, a, w, bias, resid, out, partial, M, H, W, ka, n, bn, splits,
    per, stream)."""
    from seldon_core_tpu_torch.ops._build import load_library

    fn = load_library("fused_resnet_wgmma").fused_resnet_conv_bf16
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _conv_gemm(stage: int, a: torch.Tensor, wt: torch.Tensor, bias: torch.Tensor, resid,
               out: torch.Tensor, h: int, w: int, plan, partial) -> int:
    """One conv of an identity block through the gemm kernel: ``stage`` 1
    (a = x, wt = w1), 2 (a = y1, wt = w2 as [9F, F]) or 3 (a = y2, wt =
    w3, ``resid`` = x, which ``out`` may be), a and out [M, channels], with
    ``plan`` = (tile width, splits, steps per split) and ``partial`` a
    float32 workspace of at least splits x M x N when splits > 1. No
    checks, no count; returns the launches made (2 when split)."""
    from seldon_core_tpu_torch.ops._build import launch

    m, ka = a.shape
    n = wt.shape[1]
    bn, splits, per = plan
    launch(_gemm_fn(), a.device, stage, a.data_ptr(), wt.data_ptr(), bias.data_ptr(),
           None if resid is None else resid.data_ptr(), out.data_ptr(),
           None if splits == 1 else partial.data_ptr(), m, h, w, ka, n, bn, splits, per)
    return 1 + (splits > 1)


def _check(x: torch.Tensor, params: Sequence[torch.Tensor]) -> None:
    b, h, w, c = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_identity_chain kernel takes bf16 activations, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_identity_chain: x must be a contiguous NHWC tensor")
    if x.data_ptr() % 16:
        raise ValueError("fused_identity_chain: x must start on a 16-byte boundary")
    for i in range(0, len(params), 6):
        w1, b1, w2, b2, w3, b3 = params[i:i + 6]
        f = w1.shape[1]
        want = {"w1": (w1, (c, f), torch.bfloat16), "b1": (b1, (f,), torch.float32),
                "w2": (w2, (9 * f, f), torch.bfloat16), "b2": (b2, (f,), torch.float32),
                "w3": (w3, (f, c), torch.bfloat16), "b3": (b3, (c,), torch.float32)}
        for name, (t, shape, dtype) in want.items():
            if tuple(t.shape) != shape:
                raise ValueError(f"fused_identity_chain: block {i // 6} {name} has shape "
                                 f"{tuple(t.shape)}, expected {shape}")
            if t.dtype != dtype:
                raise TypeError(f"fused_identity_chain kernel takes {dtype} {name}, got "
                                f"{t.dtype} (prepare the operands once, at load)")
            if t.device != x.device or not t.is_contiguous():
                raise ValueError(f"fused_identity_chain: {name} must be contiguous on "
                                 f"{x.device}")
            if t.data_ptr() % 16:
                raise ValueError(f"fused_identity_chain: {name} must start on a 16-byte "
                                 f"boundary")
        if c % 64 or f % 64:
            raise ValueError(f"fused_identity_chain kernel takes C and F multiples of 64, got "
                             f"C={c} F={f}")


def _gemm_chain(x: torch.Tensor, params: Sequence[torch.Tensor], plans) -> torch.Tensor:
    """The chain through the kernel: three convs per block (``plans[i]``:
    block i's three (tile width, splits, steps per split)). y1, y2, the
    output and one float32 partial workspace are allocated once for the
    chain; every block writes its output in place over the previous one's.
    No checks: ``fused_identity_chain`` makes them."""
    b, h, w, c = x.shape
    m = b * h * w
    fs = [params[i].shape[1] for i in range(0, len(params), 6)]
    y1 = torch.empty(m * max(fs), dtype=x.dtype, device=x.device)
    y2 = torch.empty_like(y1)
    out = torch.empty_like(x)
    n_partial = max((splits * m * n for plan, f in zip(plans, fs)
                     for (_, splits, _), (_, n, _) in zip(plan, _conv_dims(c, f))
                     if splits > 1), default=0)
    partial = (torch.empty(n_partial, dtype=torch.float32, device=x.device) if n_partial
               else None)
    cur = x.reshape(m, c)
    for i, (plan, f) in enumerate(zip(plans, fs)):
        w1, b1, w2, b2, w3, b3 = params[6 * i:6 * i + 6]
        a1, a2 = y1[:m * f].view(m, f), y2[:m * f].view(m, f)
        n = _conv_gemm(1, cur, w1, b1, None, a1, h, w, plan[0], partial)
        n += _conv_gemm(2, a1, w2, b2, None, a2, h, w, plan[1], partial)
        n += _conv_gemm(3, a2, w3, b3, cur, out.view(m, c), h, w, plan[2], partial)
        launches.count(fused_identity_chain, n=n)
        cur = out.view(m, c)
    return out


def _forward(x: torch.Tensor, blocks: Sequence[dict]) -> torch.Tensor:
    """The chain: its plain version for CPU tensors, the kernel for CUDA
    tensors (checked first), or raise."""
    params = _block_param_list(blocks)
    if x.device.type == "cpu":
        return identity_chain_ref(x, blocks)
    if x.device.type != "cuda":
        raise ValueError(f"fused_identity_chain: unsupported device {x.device}")
    _check(x, params)
    from seldon_core_tpu_torch.ops._build import sm_count

    b, h, w, c = x.shape
    sms = sm_count(x.device.index)
    return _gemm_chain(x, params, [_k3_plan(b, h, w, c, params[i].shape[1], sms)
                                   for i in range(0, len(params), 6)])


def identity_chain_backward(x: torch.Tensor, blocks: Sequence[dict],
                            dy: torch.Tensor) -> torch.Tensor:
    """The input gradient of the chain at ``x`` against ``dy``: autograd
    through ``identity_chain_ref`` recomputed from ``x``, the same code on
    both devices. The JAX package defines no backward for its Pallas kernel
    (``jax.grad`` differentiates the flax module), so there is no kernel to
    port; the chain's relus and bf16 hand-offs are the plain version's."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_()
        y = identity_chain_ref(xr, blocks)
        return torch.autograd.grad(y, xr, dy)[0]


class _Differentiable(torch.autograd.Function):
    """``fused_identity_chain`` under autograd: the forward is the kernel
    (the plain version for CPU tensors), the backward
    ``identity_chain_backward``."""

    @staticmethod
    def forward(ctx, x, blocks):
        ctx.save_for_backward(x)
        ctx.blocks = blocks
        return _forward(x, blocks)

    @staticmethod
    def backward(ctx, dy):
        x, = ctx.saved_tensors
        return identity_chain_backward(x, ctx.blocks, dy), None


def fused_identity_chain(x: torch.Tensor, blocks: Sequence[dict], *,
                         group: int = 1) -> torch.Tensor:
    """Run consecutive folded-BN identity bottleneck blocks over x (B, H, W,
    C). ``blocks``: per-block dicts with w1 (C, F), b1 (F,), w2 (3, 3, F, F),
    b2 (F,), w3 (F, C), b3 (C,) — ``folded_block_params``. ``group`` must
    divide B (the TPU kernel's images per program; no effect here).

    CPU tensors take the plain version. CUDA tensors launch kernels on the
    current stream (no synchronisation), or raise: x and the weights bf16,
    the biases float32, all contiguous and 16-byte aligned — operands
    prepared once, at load, never per call. Three launches per block, plus
    a reduce per split conv, as ``_k3_plan`` plans them; ``launches``
    counts them, is safe to read while other threads serve, and
    ``expected_launches`` gives what one call adds.

    Where autograd records (grad mode on and ``x`` requiring a gradient: a
    saliency explanation) the call goes through ``_Differentiable``: the
    same launches forward, ``identity_chain_backward`` for ``x``'s
    gradient. The weights are not trained: one requiring a gradient
    raises. Otherwise (serving under ``no_grad``) nothing else runs."""
    b = x.shape[0]
    if b % group:
        raise ValueError(f"batch {b} not divisible by group {group}")
    if not torch.is_grad_enabled():
        return _forward(x, blocks)
    if any(t.requires_grad for blk in blocks for t in blk.values()):
        raise ValueError("fused_identity_chain: the folded weights are not trained; only x "
                         "takes a gradient")
    if x.requires_grad:
        return _Differentiable.apply(x, blocks)
    return _forward(x, blocks)


fused_identity_chain.launches = 0


__all__ = ["expected_launches", "folded_block_params", "fused_identity_chain",
           "gemm_chain_emulated", "identity_chain_backward", "identity_chain_ref"]
