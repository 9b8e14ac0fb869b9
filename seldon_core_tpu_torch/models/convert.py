"""Carry JAX-package weights into the port.

``params_from_jax`` is the one way weights cross over: the JAX package's
param pytree (``LLMServer._params`` or ``Transformer.init``), given as nested
dicts of numpy arrays, maps onto the port's module one to one because the
port keeps flax's names and layout — ``{"layer_0": {"attention": {"wq":
[in, out]}}}`` is ``state_dict()["layer_0.attention.wq"]`` with the same
shape, no transpose. Names and shapes are checked both ways: a JAX leaf the
module has no parameter for, or a parameter the tree does not fill, raises.

A ResNet tree crosses the same way: a folded ``{"params": ...}`` tree, or
an unfused ``{"params", "batch_stats"}`` tree whose running statistics fill
the BatchNorm buffers (``bn_init.mean`` is ``batch_stats["bn_init"]
["mean"]``).

A weight-only int8 tree (the JAX package's ``quantize_params``, passed
through ``jax.tree_util.tree_map(np.asarray, ...)``) carries leaves with
``.q``, ``.scale`` and ``.orig_dtype``. The port cannot import that class,
so such a leaf is recognised by those attributes; it fills the port's
``QuantizedTensor`` at the same name (``Transformer.quantize_`` builds that
layout). A float leaf where the port holds a quantized weight is quantized
into it when the caller asks (``quantize_float=True``: the server's
``quantize="int8"`` load of a float tree, leaf by leaf) and raises
otherwise, as an int8 leaf where the port holds a float weight does.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from seldon_core_tpu_torch.models.resnet import BatchNorm
from seldon_core_tpu_torch.models.transformer import to_torch_dtype
from seldon_core_tpu_torch.ops.quantize import QuantizedTensor, quantize_into_


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


def _is_quantized_leaf(leaf) -> bool:
    return all(hasattr(leaf, a) for a in ("q", "scale", "orig_dtype"))


def _unwrap(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The flat leaves of ``tree``: flax's variables dict (``{"params":
    ...}``, plus ``"batch_stats"`` for a BatchNorm model, whose leaves join
    the params under the same module path) or the bare params dict; a
    ``"params_axes"`` entry (logical-axis metadata, no weights) is
    skipped."""
    if "params" in tree and isinstance(tree["params"], dict):
        extra = set(tree) - {"params", "params_axes", "batch_stats"}
        if extra:
            raise KeyError(f"unexpected top-level collections {sorted(extra)}")
        flat = _flatten(tree["params"])
        stats = _flatten(tree.get("batch_stats", {}))
        clash = sorted(set(flat) & set(stats))
        if clash:
            raise KeyError(f"batch_stats leaves shadow params: {clash}")
        flat.update(stats)
        return flat
    return _flatten(tree)


def has_quantized_leaves(tree: Dict[str, Any]) -> bool:
    """True when the JAX tree holds weight-only int8 leaves."""
    return any(_is_quantized_leaf(v) for v in _unwrap(tree).values())


def _copy(name: str, dst: torch.Tensor, src) -> None:
    """``src`` (a numpy array, or a tensor — the checkpoint reader gives
    bfloat16 leaves as tensors) into ``dst``, cast to its dtype."""
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.array(np.asarray(src), dtype=np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: JAX shape {tuple(src.shape)} != port shape "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


@torch.no_grad()
def params_from_jax(tree: Dict[str, Any], module: nn.Module,
                    quantize_float: bool = False) -> nn.Module:
    """Copy a JAX param tree into ``module`` (each float leaf cast to the
    parameter's own storage dtype and device; each int8 leaf's ``q`` and
    ``scale`` into the quantized weight of the same name) and return the
    module. ``tree`` is either the bare params dict or flax's variables
    dict ``{"params": ...}`` (with ``"batch_stats"`` for an unfused
    ResNet, whose running statistics fill its BatchNorm buffers).
    ``quantize_float=True`` quantizes a float leaf bound for a quantized
    weight into it (``quantize_into_``: the codes of ``quantize_array`` of
    the leaf in the weight's ``orig_dtype``), one float32 copy of one leaf
    at a time; without it that leaf raises."""
    flat = _unwrap(tree)
    targets: Dict[str, Any] = dict(module.named_parameters())
    targets.update((n, m) for n, m in module.named_modules() if isinstance(m, QuantizedTensor))
    for name, m in module.named_modules():
        if isinstance(m, BatchNorm):
            targets.update((f"{name}.{b}", getattr(m, b)) for b in ("mean", "var"))
    leftover = sorted(set(flat) - set(targets))
    if leftover:
        raise KeyError(f"JAX params with no counterpart in the port: {leftover}")
    missing = sorted(set(targets) - set(flat))
    if missing:
        raise KeyError(f"port parameters the JAX tree does not fill: {missing}")
    for name, dst in targets.items():
        src = flat[name]
        if quantize_float and isinstance(dst, QuantizedTensor) and not _is_quantized_leaf(src):
            w = torch.empty(dst.q.shape, dtype=torch.float32, device=dst.q.device)
            _copy(name, w, src)
            quantize_into_(dst, w)
            del w
            continue
        if isinstance(dst, QuantizedTensor) != _is_quantized_leaf(src):
            what = "a quantized" if isinstance(dst, QuantizedTensor) else "a float"
            raise TypeError(f"{name}: the port holds {what} weight, the JAX tree does not "
                            f"(quantize='int8' on one side only)")
        if not isinstance(dst, QuantizedTensor):
            _copy(name, dst, src)
            continue
        q = np.asarray(src.q)
        if q.dtype != np.int8:
            raise TypeError(f"{name}: JAX int8 leaf has q of dtype {q.dtype}")
        if tuple(q.shape) != tuple(dst.q.shape):
            raise ValueError(f"{name}: JAX shape {tuple(q.shape)} != port shape "
                             f"{tuple(dst.q.shape)}")
        dst.q.copy_(torch.tensor(q))
        _copy(f"{name}.scale", dst.scale, src.scale)
        dst.orig_dtype = to_torch_dtype(str(src.orig_dtype))
    return module


__all__ = ["has_quantized_leaves", "params_from_jax"]
