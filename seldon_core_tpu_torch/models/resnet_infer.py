"""Serving forward of a folded-BN ResNet: the port of
``seldon_core_tpu/models/resnet_infer.py``.

``resnet_serve_forward`` runs over the params ``fold_batchnorm`` gives
(convs with biases, no BatchNorm), NHWC, bf16 compute, float32 head. The
identity blocks of every stage named in ``pallas_stages`` (all but the
first block of a stage) run as chains through ``ops/fused_resnet``'s kernel
(K3); every other conv is ``F.conv2d`` — cuDNN on the card. The folded
``ResNet`` module names every stage, so its forward runs K3; the same
weights under ``pallas_stages=()`` give the cuDNN chain.

Numerics are those of the folded flax module (``ResNet(fused=True)``):

- a non-K3 conv gives a bf16 result and then adds its bias cast to bf16,
  two roundings (flax ``nn.Conv`` with ``dtype=bfloat16``);
- a K3 block adds the float32 bias to the float32 sum and rounds once;
- the max-pool pads with -inf; the mean over H and W is taken in float32
  and rounded to bf16; the head is float32.

Padding follows flax SAME, where the JAX package's ``resnet_serve_forward``
does not: a stride-2 3x3 conv on an even input pads (0, 1) — one row and
column after, none before — not (1, 1). On weights whose residual
branches are live the two differ (``JAXServer`` serves the flax module).

Conv kernels keep flax's HWIO layout at the public surface. The serving
operands — each conv kernel as an OIHW tensor in channels-last memory
order, the K3 operands of every identity block, biases in their working
types — are built once (``serving_operands``) and reused: a contiguous NHWC
activation permuted to NCHW is already channels-last for cuDNN, so no
layout copy happens per request.

Int8 (``ops/quantize.quantize_params``: every conv kernel and the head):
the codes stay on the device as int8, already in each operand's layout
(a ``QuantizedTensor`` whose scale is shaped to follow the output channel
there: dim 0 of an OIHW weight, the last dim of a K3 operand). Each
forward dequantizes them (``dequantize_operands``), in the
JAX package's order, ``q * scale`` in the leaf's ``orig_dtype`` then cast
to the compute dtype: plain PyTorch, where the JAX package's dequantize is
XLA's. K3 still gets bf16 weights and float32 biases; the head runs on K4
(``ops/quantize.float32_head``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from seldon_core_tpu_torch.ops.fused_resnet import fused_identity_chain
from seldon_core_tpu_torch.ops.quantize import QuantizedTensor, float32_head, leaf

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def same_pads(size: Tuple[int, int], kernel: int, stride: int) -> Pads:
    """flax/XLA SAME padding of a (H, W) input: the output is
    ceil(size / stride) and any odd total goes after."""
    out = []
    for n in size:
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        out.append((total // 2, total - total // 2))
    return tuple(out)


def _tensor(v, device, dtype=None) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, np.float32))
    return t.detach().to(device=device, dtype=dtype or torch.float32)


def conv_weight(kernel, device, dtype):
    """An HWIO kernel as the OIHW weight ``F.conv2d`` takes, stored
    channels-last (O, H, W, I in memory) in ``dtype``; a quantized kernel
    as a ``QuantizedTensor`` in that layout, its scale over dim 0."""
    if isinstance(kernel, QuantizedTensor):
        q = kernel.q.detach().to(device).permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
        return QuantizedTensor(q, kernel.scale.detach().to(device).view(-1, 1, 1, 1),
                               kernel.orig_dtype)
    k = _tensor(kernel, device, dtype)
    return k.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)


def _k3_weight(kernel, device, dtype):
    """A folded block's kernel as its K3 operand (1x1 kernels lose their
    unit dims, the 3x3 stays HWIO), contiguous in ``dtype``; quantized, a
    ``QuantizedTensor`` whose scale stays on the last (output) dim."""
    if isinstance(kernel, QuantizedTensor):
        q = kernel.q.detach().to(device)
        q = (q.reshape(q.shape[-2:]) if q.shape[0] == 1 else q).contiguous()
        return QuantizedTensor(q, kernel.scale.detach().to(device), kernel.orig_dtype)
    k = _tensor(kernel, device, dtype)
    return (k.reshape(k.shape[-2:]) if k.shape[0] == 1 else k).contiguous()


def dequantize_operands(ops, dtype):
    """``ops`` with every quantized conv and K3 weight dequantized to
    ``dtype`` (the forward's weights, made anew each call); the head, a
    ``(kernel, bias)`` tuple, is not walked and stays int8 for K4. An
    unquantized tree comes back as it is."""
    if isinstance(ops, QuantizedTensor):
        return leaf(ops, dtype)
    if isinstance(ops, dict):
        return {k: dequantize_operands(v, dtype) for k, v in ops.items()}
    if isinstance(ops, list):
        return [dequantize_operands(v, dtype) for v in ops]
    return ops


def conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
         pads: Pads) -> torch.Tensor:
    """NHWC conv in x's dtype (the result rounded once) plus the bias in
    x's dtype (a second rounding): flax ``nn.Conv(dtype=...)``."""
    (pt, pb), (pl, pr) = pads
    xc = x.permute(0, 3, 1, 2)
    if pt == pb and pl == pr:
        y = F.conv2d(xc, weight, stride=stride, padding=(pt, pl))
    else:
        y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), weight, stride=stride)
    y = y.permute(0, 2, 3, 1)
    return y if bias is None else y + bias


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max-pool padded (1, 1) with -inf, NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def space_to_depth(x, block: int = 2):
    """(B, H, W, C) -> (B, H/b, W/b, b*b*C), channel order (di, dj, c); a
    numpy array or a torch tensor."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.transpose(0, 1, 3, 2, 4, 5) if isinstance(x, np.ndarray) else x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, block * block * c)


def _conv_ops(scope, device, dtype) -> Dict[str, torch.Tensor]:
    bias = scope.get("bias")
    return {"w": conv_weight(scope["kernel"], device, dtype),
            "b": None if bias is None else _tensor(bias, device, dtype)}


def serving_operands(params: Dict[str, Any], stage_sizes: Sequence[int], device,
                     dtype=torch.bfloat16) -> Dict[str, Any]:
    """Every operand the folded forward needs, built once from a folded
    param tree (flax names, HWIO kernels; numpy arrays or tensors, or
    ``QuantizedTensor`` kernels): conv weights in channels-last OIHW and
    ``dtype``, their biases in ``dtype``, the K3 dict of every identity
    block (weights in ``dtype`` and contiguous, biases float32) and the
    float32 head. A quantized kernel stays int8 (a re-laid-out
    ``QuantizedTensor``) until ``dequantize_operands``; a quantized head
    stays a ``QuantizedTensor`` for K4."""
    device = torch.device(device)
    ops: Dict[str, Any] = {}
    if "conv_init_s2d" in params:
        ops["stem"] = dict(_conv_ops(params["conv_init_s2d"], device, dtype), s2d=True)
    else:
        ops["stem"] = dict(_conv_ops(params["conv_init"], device, dtype), s2d=False)
    blocks: List[Dict[str, Any]] = []
    for i in range(sum(stage_sizes)):
        scope = params[f"BottleneckBlock_{i}"]
        blk = {name: _conv_ops(scope[name], device, dtype)
               for name in ("Conv_0", "Conv_1", "Conv_2", "conv_proj") if name in scope}
        if "conv_proj" not in scope:
            blk["k3"] = {f"w{j + 1}": _k3_weight(scope[f"Conv_{j}"]["kernel"], device, dtype)
                         for j in range(3)}
            blk["k3"].update({f"b{j + 1}": _tensor(scope[f"Conv_{j}"]["bias"], device).contiguous()
                              for j in range(3)})
        blocks.append(blk)
    ops["blocks"] = blocks
    kernel = params["head"]["kernel"]
    if isinstance(kernel, QuantizedTensor):
        kernel = QuantizedTensor(kernel.q.to(device), kernel.scale.to(device), kernel.orig_dtype)
    else:
        kernel = _tensor(kernel, device)
    ops["head"] = (kernel, _tensor(params["head"]["bias"], device))
    return ops


def stem(ops: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """conv_init (7x7 stride 2, pads 3) — or the space-to-depth stem, a 4x4
    stride-1 conv padded (2, 1) over the 2x2-packed image — then relu and
    the max-pool."""
    s = ops["stem"]
    if s["s2d"]:
        if x.shape[-1] == 3:
            x = space_to_depth(x)
        x = conv(x, s["w"], s["b"], 1, ((2, 1), (2, 1)))
    else:
        x = conv(x, s["w"], s["b"], 2, ((3, 3), (3, 3)))
    return max_pool(torch.relu(x))


def bottleneck(x: torch.Tensor, blk: Dict[str, Any], stride: int) -> torch.Tensor:
    """One folded bottleneck block through F.conv2d (flax padding)."""
    size = tuple(x.shape[1:3])
    y = torch.relu(conv(x, blk["Conv_0"]["w"], blk["Conv_0"]["b"], 1, ((0, 0), (0, 0))))
    y = torch.relu(conv(y, blk["Conv_1"]["w"], blk["Conv_1"]["b"], stride,
                        same_pads(size, 3, stride)))
    y = conv(y, blk["Conv_2"]["w"], blk["Conv_2"]["b"], 1, ((0, 0), (0, 0)))
    residual = x
    if "conv_proj" in blk:
        residual = conv(x, blk["conv_proj"]["w"], blk["conv_proj"]["b"], stride,
                        same_pads(size, 1, stride))
    return torch.relu(residual + y)


def head(ops: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W in float32, rounded to the working dtype, then the
    float32 classifier."""
    x = x.float().mean(dim=(1, 2)).to(x.dtype)
    kernel, bias = ops["head"]
    return float32_head(x, kernel) + bias


def forward_operands(ops: Dict[str, Any], x: torch.Tensor, stage_sizes: Sequence[int],
                     dtype=torch.bfloat16, pallas_stages: Sequence[int] = ()) -> torch.Tensor:
    """The folded forward over prepared ``serving_operands`` (int8 ones
    dequantized first, for this call)."""
    ops = dequantize_operands(ops, dtype)
    x = stem(ops, x.to(dtype))
    idx = 0
    for i, n_blocks in enumerate(stage_sizes):
        blocks = ops["blocks"][idx:idx + n_blocks]
        idx += n_blocks
        x = bottleneck(x, blocks[0], 2 if i > 0 else 1)
        identity = blocks[1:]
        if i in pallas_stages and identity:
            if not all("k3" in b for b in identity):
                raise ValueError(f"stage {i}: pallas_stages requires projection-free "
                                 f"non-opening blocks; a conv_proj would be silently dropped "
                                 f"by the fused kernel")
            x = fused_identity_chain(x.contiguous(), [b["k3"] for b in identity])
        else:
            for blk in identity:
                x = bottleneck(x, blk, 1)
    return head(ops, x)


def resnet_serve_forward(variables_or_module, x: torch.Tensor, *,
                         stage_sizes: Sequence[int] = (3, 4, 6, 3), dtype=torch.bfloat16,
                         pallas_stages: Sequence[int] = ()) -> torch.Tensor:
    """Forward over folded params (ResNet-50 by default) on x's device.

    ``variables_or_module``: flax's ``{"params": ...}`` of a folded model
    (numpy arrays or tensors; its operands are built for this call), or a
    folded ``ResNet`` module (its operands are built once and cached; its
    own ``stage_sizes`` and ``dtype`` apply). ``pallas_stages``: 0-based
    stages whose identity blocks run as K3 chains; () is the cuDNN chain."""
    if isinstance(variables_or_module, torch.nn.Module):
        module = variables_or_module
        ops = module.serving_operands(x.device)
        stage_sizes, dtype = module.stage_sizes, module.dtype
    else:
        ops = serving_operands(variables_or_module["params"], stage_sizes, x.device, dtype)
    return forward_operands(ops, x, stage_sizes, dtype, pallas_stages)


__all__ = ["conv", "conv_weight", "dequantize_operands", "forward_operands", "max_pool",
           "resnet_serve_forward", "same_pads", "serving_operands", "space_to_depth"]
