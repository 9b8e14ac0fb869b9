"""MLP classifier: the port of ``seldon_core_tpu/models/mlp.py``.

``Dense_0 .. Dense_n`` in flax's names and layouts (``kernel`` [in, out],
``bias`` [out]), relu between them, the products in ``dtype`` (bf16 by
default) and the softmax over float32 logits. An int8 checkpoint's kernels
(``ops/quantize.quantize_params``) run on K4 under bf16 compute and as the
dequantized product under float32 (``ops/quantize.linear``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.models.layers import Dense, init_live_, param, param_tree
from seldon_core_tpu_torch.models.registry import register_model
from seldon_core_tpu_torch.models.transformer import to_torch_dtype
from seldon_core_tpu_torch.ops.quantize import leaf, linear


class MLP(nn.Module):
    """``forward(x)`` [B, F] -> class probabilities [B, num_classes],
    float32. ``input_shape`` ([F]) sizes ``Dense_0``'s kernel, as flax's
    ``init`` does from its example input; without it ``size_from_input``
    must run before the weights load."""

    def __init__(self, features: Sequence[int] = (128, 128), num_classes: int = 3,
                 dtype="bfloat16", input_shape: Optional[Sequence[int]] = None, device=None):
        super().__init__()
        self.features = tuple(int(f) for f in features)
        self.num_classes = int(num_classes)
        self.dtype = to_torch_dtype(dtype)
        widths = [None, *self.features, self.num_classes]
        for i in range(len(widths) - 1):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1], device))
        if input_shape is not None:
            self.size_from_input(input_shape)

    def layers(self):
        return [getattr(self, f"Dense_{i}") for i in range(len(self.features) + 1)]

    def size_from_input(self, input_shape: Sequence[int]) -> "MLP":
        """Create ``Dense_0``'s kernel for per-sample inputs of
        ``input_shape`` (its last dim is the feature count)."""
        first = self.Dense_0
        n_in = int(input_shape[-1])
        have = getattr(first, "kernel", None)
        if have is not None:
            if have.shape[0] != n_in:
                raise ValueError(f"MLP sized for {have.shape[0]} input features, not {n_in}")
            return self
        first.kernel = param(n_in, first.n_out, device=first.bias.device)
        return self

    def param_tree(self):
        return param_tree(self)

    def init_params(self, generator: Optional[torch.Generator] = None) -> "MLP":
        return init_live_(self, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        del train   # the vision-family calling convention; nothing is train-only
        dt = self.dtype
        x = x.to(dt)
        for i, layer in enumerate(self.layers()):
            x = linear(x, layer.kernel) + leaf(layer.bias, dt)
            if i < len(self.features):
                x = torch.relu(x)
        return torch.softmax(x.float(), dim=-1)


@register_model("mlp")
def make_mlp(features: Sequence[int] = (128, 128), num_classes: int = 3,
             dtype: str = "bfloat16", input_shape=None, device=None):
    dev = device if str(device) == "meta" else resolve_device(device)
    return MLP(features, num_classes, dtype, input_shape, dev)


__all__ = ["MLP"]
