"""Carry JAX-package weights into the port.

``params_from_jax`` is the one way weights cross over: the JAX package's
param pytree (``LLMServer._params`` or ``Transformer.init``), given as nested
dicts of numpy arrays, maps onto the port's module one to one because the
port keeps flax's names and layout — ``{"layer_0": {"attention": {"wq":
[in, out]}}}`` is ``state_dict()["layer_0.attention.wq"]`` with the same
shape, no transpose. Names and shapes are checked both ways: a JAX leaf the
module has no parameter for, or a parameter the tree does not fill, raises.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


@torch.no_grad()
def params_from_jax(tree: Dict[str, Any], module: nn.Module) -> nn.Module:
    """Copy a JAX param tree into ``module``'s parameters (each cast to the
    parameter's own storage dtype and device) and return the module.

    ``tree`` is either the bare params dict or flax's variables dict
    ``{"params": ...}``; a ``"params_axes"`` entry beside it (flax's
    logical-axis metadata, no weights) is skipped."""
    if "params" in tree and isinstance(tree["params"], dict):
        extra = set(tree) - {"params", "params_axes"}
        if extra:
            raise KeyError(f"unexpected top-level collections {sorted(extra)}")
        tree = tree["params"]
    flat = _flatten(tree)
    params = dict(module.named_parameters())
    leftover = sorted(set(flat) - set(params))
    if leftover:
        raise KeyError(f"JAX params with no counterpart in the port: {leftover}")
    missing = sorted(set(params) - set(flat))
    if missing:
        raise KeyError(f"port parameters the JAX tree does not fill: {missing}")
    for name, p in params.items():
        arr = np.asarray(flat[name])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {tuple(arr.shape)} != port shape "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    return module


__all__ = ["params_from_jax"]
