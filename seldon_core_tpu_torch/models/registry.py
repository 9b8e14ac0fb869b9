"""Model registry: names -> torch module constructors.

Port of ``seldon_core_tpu/models/registry.py``. ``LLMServer`` and
``TorchServer`` resolve their ``model`` name here (the transformer family,
ResNet-18/50/101, the MLP and ViT-B/16 / ViT-tiny are built in); users register their own architectures with
``register_model``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register_model(name: str, ctor: Callable[..., Any] = None):
    """Register a model constructor; usable as a decorator."""

    def _register(fn):
        _REGISTRY[name] = fn
        return fn

    if ctor is not None:
        return _register(ctor)
    return _register


def get_model(name: str, **kwargs: Any):
    if name not in _REGISTRY:
        # Import built-in model families lazily so registry import stays light.
        import seldon_core_tpu_torch.models.mlp  # noqa: F401
        import seldon_core_tpu_torch.models.resnet  # noqa: F401
        import seldon_core_tpu_torch.models.transformer  # noqa: F401
        import seldon_core_tpu_torch.models.vit  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"Unknown model {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
