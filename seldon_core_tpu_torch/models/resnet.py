"""ResNet family (v1.5 bottleneck) as torch modules: the port of
``seldon_core_tpu/models/resnet.py``.

The public surface keeps the JAX package's: NHWC inputs, bf16 compute, a
float32 head, and flax's parameter names and shapes (HWIO conv kernels),
so ``state_dict()["BottleneckBlock_3.Conv_1.kernel"]`` is the flax leaf
``params["BottleneckBlock_3"]["Conv_1"]["kernel"]`` and weights cross over
with ``models/convert.params_from_jax`` unchanged. Convolutions follow flax
padding: explicit (3, 3) for the 7x7 stem, SAME elsewhere — (0, 1) for a
stride-2 3x3 conv on an even input.

``fused=True`` is the folded inference model (``fold_batchnorm``): convs
carry biases and there is no BatchNorm. ``fused=False`` keeps BatchNorm
with its running statistics as buffers (eps 1e-5). Only inference is
ported: ``train=True`` raises.

Why the folded forward runs K3 on the card while ``JAXServer`` runs XLA's
graph: in the JAX package the fused-chain kernel is opt-in
(``resnet_infer.resnet_serve_forward(pallas_stages=...)``) because on the
TPU XLA's fused conv graph beat it. The port has no XLA; its counterpart of
"apply the folded module" is its own eager code, so the folded forward is
``resnet_serve_forward`` with every stage's identity chain on the
hand-written kernel (``ops/fused_resnet``). ``resnet_serve_forward(module,
x, pallas_stages=())`` runs the same weights through the cuDNN chain.

The forward records autograd only for an input that requires a gradient
(the weights never do): a saliency explanation takes the input gradient
through K3's own backward (``ops/fused_resnet``). ``TorchServer`` casts the
weights (``param_dtype``) and quantizes them (``quantize="int8"``: the
conv kernels and the head, ``ops/quantize.quantize_params``) after they
load; ``resnet_infer`` says how int8 operands run.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.models.layers import param_tree
from seldon_core_tpu_torch.models.registry import register_model
from seldon_core_tpu_torch.models.resnet_infer import (conv, conv_weight, head, max_pool,
                                                       resnet_serve_forward, same_pads,
                                                       serving_operands, space_to_depth)
from seldon_core_tpu_torch.models.transformer import to_torch_dtype
from seldon_core_tpu_torch.ops.quantize import leaf

BN_EPS = 1e-5  # flax BatchNorm epsilon of the JAX module


def _param(*shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device),
                        requires_grad=False)


class Conv(nn.Module):
    """flax ``nn.Conv`` parameters: ``kernel`` (kh, kw, in, out) and, when
    ``use_bias``, ``bias`` (out,)."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int, use_bias: bool, device=None):
        super().__init__()
        self.kernel = _param(kh, kw, cin, cout, device=device)
        self.bias = _param(cout, device=device) if use_bias else None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` in inference: ``scale`` and ``bias`` params,
    the running ``mean`` and ``var`` as buffers (flax's batch_stats)."""

    def __init__(self, n: int, device=None):
        super().__init__()
        self.scale = _param(n, device=device)
        self.bias = _param(n, device=device)
        self.register_buffer("mean", torch.zeros(n, device=device))
        self.register_buffer("var", torch.ones(n, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(x - mean) * (rsqrt(var + eps) * scale) + bias in float32, cast
        back to x's dtype — flax's ``_normalize``."""
        y = (x.float() - self.mean) * (torch.rsqrt(self.var + BN_EPS) * self.scale) + self.bias
        return y.to(x.dtype)


class BottleneckBlock(nn.Module):
    """Conv_0 1x1 -> Conv_1 3x3 (stride) -> Conv_2 1x1 (x4 filters), with
    BatchNorm_0..2 unless folded; ``conv_proj`` (+ ``norm_proj``) when the
    residual changes shape."""

    def __init__(self, cin: int, filters: int, stride: int, fused: bool, device=None):
        super().__init__()
        self.stride = stride
        self.Conv_0 = Conv(1, 1, cin, filters, fused, device)
        self.Conv_1 = Conv(3, 3, filters, filters, fused, device)
        self.Conv_2 = Conv(1, 1, filters, 4 * filters, fused, device)
        self.project = stride != 1 or cin != 4 * filters
        if self.project:
            self.conv_proj = Conv(1, 1, cin, 4 * filters, fused, device)
        if not fused:
            for i in range(3):
                self.add_module(f"BatchNorm_{i}", BatchNorm(filters * (4 if i == 2 else 1),
                                                            device))
            if self.project:
                self.norm_proj = BatchNorm(4 * filters, device)


class ResNet(nn.Module):
    """ResNet over NHWC images; ``forward(x)`` returns float32 logits.

    ``fused=True``: the folded model; its forward is
    ``resnet_serve_forward`` with every stage in ``pallas_stages`` — each
    identity chain through the K3 kernel on the card, its plain version on
    the CPU. ``stem_s2d=True`` (folded only): the 7x7/s2 stem as the
    equivalent 4x4/s1 conv ``conv_init_s2d`` over the 2x2 space-to-depth
    packed image (``fold_space_to_depth``). ``fused=False``: BatchNorm with
    running statistics, every conv through ``F.conv2d``.

    The folded model's serving operands (``serving_operands``) are built
    from the parameters at first use on a device and rebuilt only when a
    parameter changes."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype="bfloat16", fused: bool = False,
                 stem_s2d: bool = False, device=None):
        super().__init__()
        if stem_s2d and not fused:
            raise ValueError("stem_s2d=True requires fused=True (inference-only)")
        self.stage_sizes = tuple(stage_sizes)
        self.num_classes = num_classes
        self.dtype = to_torch_dtype(dtype)
        self.fused = fused
        self.stem_s2d = stem_s2d
        if stem_s2d:
            self.conv_init_s2d = Conv(4, 4, 12, num_filters, True, device)
        else:
            self.conv_init = Conv(7, 7, 3, num_filters, fused, device)
        if not fused:
            self.bn_init = BatchNorm(num_filters, device)
        cin, idx = num_filters, 0
        for i, n in enumerate(self.stage_sizes):
            for j in range(n):
                filters = num_filters * 2 ** i
                stride = 2 if i > 0 and j == 0 else 1
                self.add_module(f"BottleneckBlock_{idx}",
                                BottleneckBlock(cin, filters, stride, fused, device))
                cin, idx = 4 * filters, idx + 1
        self.head = nn.Module()
        self.head.kernel = _param(cin, num_classes, device=device)
        self.head.bias = _param(num_classes, device=device)
        self._ops_lock = threading.Lock()
        self._ops = None  # (key, serving operands)

    def blocks(self):
        return [getattr(self, f"BottleneckBlock_{i}") for i in range(sum(self.stage_sizes))]

    # -- parameters -------------------------------------------------------
    def param_tree(self) -> Dict[str, Any]:
        """The parameters as flax's nested ``params`` dict of tensors (an
        int8 kernel as its ``QuantizedTensor``; batch statistics
        excluded)."""
        return param_tree(self)

    @torch.no_grad()
    def init_params(self, generator: Optional[torch.Generator] = None) -> "ResNet":
        """Seeded random weights whose residual branches are live, drawn in
        module order on the parameters' device: every conv kernel and the
        head kernel lecun-normal (std 1/sqrt(fan_in)); conv biases normal
        (0.05); BatchNorm scales uniform in [0.5, 1.5] — never flax's zero
        init of a block's last scale, which switches the branch off —
        biases and running means normal (0.1), variances uniform in [0.5,
        1.5]; the head bias zero."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = self.get_submodule(name.rsplit(".", 1)[0])
            if leaf == "kernel":
                fan_in = int(np.prod(p.shape[:-1]))
                p.normal_(0.0, fan_in ** -0.5, generator=generator)
            elif isinstance(owner, BatchNorm) and leaf == "scale":
                p.uniform_(0.5, 1.5, generator=generator)
            elif name == "head.bias":
                p.zero_()
            else:
                p.normal_(0.0, 0.1 if isinstance(owner, BatchNorm) else 0.05,
                          generator=generator)
        for name, buf in self.named_buffers():
            if name.endswith(".mean"):
                buf.normal_(0.0, 0.1, generator=generator)
            else:
                buf.uniform_(0.5, 1.5, generator=generator)
        return self

    def serving_operands(self, device) -> Dict[str, Any]:
        """The folded forward's operands on ``device`` (see
        ``resnet_infer.serving_operands``), cached until a parameter is
        changed in place or replaced (int8 codes and scales included)."""
        if not self.fused:
            raise ValueError("serving operands exist for the folded model (fused=True) only")
        device = torch.device(device)
        key = (device, tuple((id(p), p._version)
                             for p in [*self.parameters(), *self.buffers()]))
        with self._ops_lock:
            if self._ops is None or self._ops[0] != key:
                self._ops = (key, serving_operands(self.param_tree(), self.stage_sizes, device,
                                                   self.dtype))
            return self._ops[1]

    # -- forward ----------------------------------------------------------
    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            if self.fused:
                raise ValueError("fused=True is inference-only (BN is folded away)")
            raise NotImplementedError("training (BatchNorm batch statistics) is not ported: "
                                      "the port serves inference only")
        if self.fused:
            return resnet_serve_forward(self, x,
                                        pallas_stages=tuple(range(len(self.stage_sizes))))
        return self._forward_bn(x)

    def _forward_bn(self, x: torch.Tensor) -> torch.Tensor:
        dtype, dev = self.dtype, x.device

        def c(m: Conv, y, stride, pads):   # an int8 kernel dequantized, as JAX's forward does
            return conv(y, conv_weight(leaf(m.kernel, dtype), dev, dtype), None, stride, pads)

        x = c(self.conv_init, x.to(dtype), 2, ((3, 3), (3, 3)))
        x = max_pool(torch.relu(self.bn_init(x)))
        for blk in self.blocks():
            size = tuple(x.shape[1:3])
            y = torch.relu(blk.BatchNorm_0(c(blk.Conv_0, x, 1, ((0, 0), (0, 0)))))
            y = torch.relu(blk.BatchNorm_1(c(blk.Conv_1, y, blk.stride,
                                             same_pads(size, 3, blk.stride))))
            y = blk.BatchNorm_2(c(blk.Conv_2, y, 1, ((0, 0), (0, 0))))
            residual = x
            if blk.project:
                residual = blk.norm_proj(c(blk.conv_proj, x, blk.stride,
                                           same_pads(size, 1, blk.stride)))
            x = torch.relu(residual + y)
        return head({"head": (self.head.kernel, self.head.bias)}, x)


# ---------------------------------------------------------------------------
# Folding, on numpy trees (flax's nested dicts)
# ---------------------------------------------------------------------------

def _fold_pair(conv_scope, bn, bn_stats) -> Dict[str, np.ndarray]:
    """BN(conv(x)) = conv(x) * s + b, s = scale * rsqrt(var + eps), b = bias
    - mean * s: s scales the kernel's output channels, b becomes the conv
    bias. In float32, as the JAX package folds."""
    f32 = np.float32
    s = np.asarray(bn["scale"], f32) * (1.0 / np.sqrt(np.asarray(bn_stats["var"], f32)
                                                      + f32(BN_EPS))).astype(f32)
    b = np.asarray(bn["bias"], f32) - np.asarray(bn_stats["mean"], f32) * s
    kernel = np.asarray(conv_scope["kernel"])
    return {"kernel": (kernel.astype(f32) * s).astype(kernel.dtype), "bias": b}


def fold_batchnorm(variables: Dict[str, Any]) -> Dict[str, Any]:
    """Fold BatchNorm into the adjacent convs: trained ``{"params",
    "batch_stats"}`` -> ``{"params"}`` for the ``fused=True`` model. Pairs:
    conv_init/bn_init, Conv_j/BatchNorm_j, conv_proj/norm_proj; the head
    passes through."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, Any] = {}
    for key, scope in params.items():
        if key == "conv_init":
            out[key] = _fold_pair(scope, params["bn_init"], stats["bn_init"])
        elif key.startswith("BottleneckBlock_"):
            block: Dict[str, Any] = {}
            for ck, cv in scope.items():
                if ck.startswith("Conv_"):
                    bn_key = "BatchNorm_" + ck.split("_")[1]
                    block[ck] = _fold_pair(cv, scope[bn_key], stats[key][bn_key])
                elif ck == "conv_proj":
                    block[ck] = _fold_pair(cv, scope["norm_proj"], stats[key]["norm_proj"])
            out[key] = block
        elif key == "bn_init" or key.startswith("BatchNorm") or key == "norm_proj":
            continue
        else:
            out[key] = scope
    return {"params": out}


def fold_space_to_depth(variables: Dict[str, Any]) -> Dict[str, Any]:
    """Refold a folded conv_init (7, 7, C, F) kernel into the equivalent
    conv_init_s2d (4, 4, 4C, F) kernel of the ``stem_s2d=True`` model: a
    zero tap in front of the 7 (offset -4 is never read), then
    K[a, b, (di, dj, c), f] = Wpad[2a + di, 2b + dj, c, f]."""
    params = dict(variables["params"])
    stem = params.pop("conv_init")
    w = np.asarray(stem["kernel"])
    kh, kw, c, f = w.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"fold_space_to_depth expects a 7x7 stem, got {(kh, kw)}")
    wpad = np.pad(w, ((1, 0), (1, 0), (0, 0), (0, 0)))
    k = wpad.reshape(4, 2, 4, 2, c, f).transpose(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * c, f)
    params["conv_init_s2d"] = {"kernel": k, "bias": stem["bias"]}
    return {"params": params}


def _make(stage_sizes, num_classes, dtype, fused, stem_s2d, device) -> ResNet:
    dev = device if str(device) == "meta" else resolve_device(device)
    return ResNet(stage_sizes, num_classes=num_classes, dtype=dtype, fused=fused,
                  stem_s2d=stem_s2d, device=dev)


@register_model("resnet50")
def make_resnet50(num_classes: int = 1000, dtype: str = "bfloat16", fused: bool = False,
                  stem_s2d: bool = False, device=None):
    return _make((3, 4, 6, 3), num_classes, dtype, fused, stem_s2d, device)


@register_model("resnet18")
def make_resnet18(num_classes: int = 1000, dtype: str = "bfloat16", fused: bool = False,
                  stem_s2d: bool = False, device=None):
    # the JAX package's 18-layer variant: the bottleneck stack at (2, 2, 2, 2)
    return _make((2, 2, 2, 2), num_classes, dtype, fused, stem_s2d, device)


@register_model("resnet101")
def make_resnet101(num_classes: int = 1000, dtype: str = "bfloat16", fused: bool = False,
                   stem_s2d: bool = False, device=None):
    return _make((3, 4, 23, 3), num_classes, dtype, fused, stem_s2d, device)


__all__ = ["BatchNorm", "BottleneckBlock", "Conv", "ResNet", "fold_batchnorm",
           "fold_space_to_depth", "space_to_depth"]
