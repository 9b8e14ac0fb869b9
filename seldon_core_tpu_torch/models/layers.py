"""Parameter holders and numerics shared by the port's MLP and ViT
(``models/mlp.py``, ``models/vit.py``): flax's names and layouts, so
``state_dict()["Dense_0.kernel"]`` is the flax leaf
``params["Dense_0"]["kernel"]`` and weights cross over with
``models/convert.params_from_jax`` unchanged.

Some flax parameters take their shape from the example input at ``init``
(a ``Dense``'s input features, a conv's input channels, the ViT's
``pos_embed``). The port's modules take the per-sample input shape instead:
at construction (``input_shape=``) or later through ``size_from_input``,
which ``TorchServer`` calls with the checkpoint's ``input_shape``.

Every weight is a float32 ``nn.Parameter`` with ``requires_grad=False``:
the port serves these models (and explains them with input gradients); it
does not train them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from seldon_core_tpu_torch.ops.quantize import leaves

LN_EPS = 1e-6   # flax nn.LayerNorm's epsilon (torch's default is 1e-5)


def param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device),
                        requires_grad=False)


class Dense(nn.Module):
    """flax ``nn.Dense`` parameters: ``kernel`` [in, out] and ``bias`` [out].
    ``n_in`` None leaves the kernel to ``size_from_input``."""

    def __init__(self, n_in: Optional[int], n_out: int, device=None):
        super().__init__()
        self.n_out = n_out
        if n_in is not None:
            self.kernel = param(n_in, n_out, device=device)
        self.bias = param(n_out, device=device)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` parameters: ``scale`` and ``bias`` [d]."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = param(d, device=device)
        self.bias = param(d, device=device)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dtype)``: the statistics in float32 by its
    fast variance (E[x^2] - E[x]^2, clipped at 0), ``(x - mean) *
    (rsqrt(var + 1e-6) * scale) + bias`` in float32, cast to ``dtype``."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + LN_EPS) * scale.float()
    return ((x32 - mean) * mul + bias.float()).to(dtype)


def param_tree(source: Union[nn.Module, Dict[str, Any]]) -> Dict[str, Any]:
    """A module's weights as flax's nested ``params`` dict: float leaves as
    tensors, int8 leaves as their ``QuantizedTensor``; or the same nesting
    of a flat ``{dotted name: leaf}`` dict (``ops/quantize.dequantize_params``)."""
    tree: Dict[str, Any] = {}
    flat = leaves(source) if isinstance(source, nn.Module) else source
    for name, t in flat.items():
        node = tree
        *path, last = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = t
    return tree


@torch.no_grad()
def init_live_(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Seeded random weights, drawn in module order on the parameters'
    device, every one of them live (never flax's zero init of a bias,
    ``cls`` or the ViT's head, which would leave an input gradient of
    zero): kernels of two or more dims normal with std 1/sqrt(fan_in)
    (fan_in = every dim but the last), LayerNorm scales uniform in [0.5,
    1.5], every other leaf normal(0.02)."""
    for name, p in module.named_parameters():
        owner = module.get_submodule(name.rpartition(".")[0]) if "." in name else module
        if isinstance(owner, LayerNorm) and name.endswith(".scale"):
            p.uniform_(0.5, 1.5, generator=generator)
        elif p.dim() >= 2 and name.rpartition(".")[2] not in ("cls", "pos_embed"):
            fan_in = p.numel() // p.shape[-1]
            p.normal_(0.0, fan_in ** -0.5, generator=generator)
        else:
            p.normal_(0.0, 0.02, generator=generator)
    return module


__all__ = ["Dense", "LN_EPS", "LayerNorm", "init_live_", "layer_norm", "param", "param_tree"]
