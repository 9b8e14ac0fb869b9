"""Folded-BN ResNet identity bottleneck chains: a CUDA C++ kernel for Hopper,
and its plain PyTorch version.

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

The kernel (``csrc/fused_resnet.cu``) runs one launch per block: one CTA
per (image, band of output rows) keeps y1, its halo rows and y2 in shared
memory, and the activation written between blocks is exactly the bf16
hand-off of the plain version. The source says what bounds it and how the
design handles the 3x3 conv's zero padding. The TPU kernel's ``group``
(images per grid program, sized for the TPU's matrix unit) keeps its
``ValueError`` and has no other effect here.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence

import torch
import torch.nn.functional as F

_count_lock = threading.Lock()


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


def _kernel_fns():
    """(launch entry point, band-rows query) of ``csrc/fused_resnet.cu``."""
    fns = _kernel_fns.fns
    if fns is None:
        from seldon_core_tpu_torch.ops._build import load_library

        lib = load_library("fused_resnet")
        run = lib.fused_identity_block_bf16
        run.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        run.restype = ctypes.c_int
        rows = lib.fused_identity_block_band_rows
        rows.argtypes = [ctypes.c_int] * 3
        rows.restype = ctypes.c_int
        fns = _kernel_fns.fns = (run, rows)
    return fns


_kernel_fns.fns = None


def _check(x: torch.Tensor, params: Sequence[torch.Tensor]) -> None:
    b, h, w, c = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_identity_chain kernel takes bf16 activations, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_identity_chain: x must be a contiguous NHWC tensor")
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
        if c % 64 or f % 64:
            raise ValueError(f"fused_identity_chain kernel takes C and F multiples of 64, got "
                             f"C={c} F={f}")
        if _kernel_fns()[1](h, w, f) == 0:
            raise ValueError(f"fused_identity_chain kernel takes no band of ({h}, {w}) pixels "
                             f"at F={f}: one row and its halo rows must fit 256 tile rows "
                             f"and the CTA's shared memory")


def fused_identity_chain(x: torch.Tensor, blocks: Sequence[dict], *,
                         group: int = 1) -> torch.Tensor:
    """Run consecutive folded-BN identity bottleneck blocks over x (B, H, W,
    C). ``blocks``: per-block dicts with w1 (C, F), b1 (F,), w2 (3, 3, F, F),
    b2 (F,), w3 (F, C), b3 (C,) — ``folded_block_params``. ``group`` must
    divide B (the TPU kernel's images per program; no effect here).

    CPU tensors take the plain version. CUDA tensors launch the kernel once
    per block on the current stream (no synchronisation), or raise: x and
    the weights bf16, the biases float32, all contiguous — operands prepared
    once, at load, never per call. ``launches`` counts kernel launches (one
    per block) and is safe to read while other threads serve."""
    b, h, w, c = x.shape
    if b % group:
        raise ValueError(f"batch {b} not divisible by group {group}")
    params = _block_param_list(blocks)
    if x.device.type == "cpu":
        return identity_chain_ref(x, blocks)
    if x.device.type != "cuda":
        raise ValueError(f"fused_identity_chain: unsupported device {x.device}")
    _check(x, params)
    from seldon_core_tpu_torch.ops._build import launch

    fn = _kernel_fns()[0]
    for i in range(0, len(params), 6):
        w1, b1, w2, b2, w3, b3 = params[i:i + 6]
        out = torch.empty_like(x)
        launch(fn, x.device, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
               b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(), b, h, w, c,
               w1.shape[1])
        with _count_lock:
            fused_identity_chain.launches += 1
        x = out
    return x


fused_identity_chain.launches = 0


__all__ = ["folded_block_params", "fused_identity_chain", "identity_chain_ref"]
