"""The user component contract: the port of
``seldon_core_tpu/components/component.py``.

High-level methods receive arrays/bytes/str plus feature names and meta;
``*_raw`` escape hatches receive the full SeldonMessage;
``metrics()``/``tags()``/``class_names()``/``feature_names()`` enrich
responses. The ``client_*`` helpers call a component's method when it
defines one and fall back as the reference does. ``torch_fn()`` is the port
of the JAX package's ``jax_fn()`` fusion hook: the graph engine composes a
router-free subtree of components that expose it into one function on its
device (``runtime/engine.py``).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from seldon_core_tpu_torch.contracts.payload import Feedback, SeldonError, SeldonMessage

logger = logging.getLogger(__name__)

_METRIC_TYPES = ("COUNTER", "GAUGE", "TIMER")


def validate_metrics(metrics: Any) -> bool:
    """Schema check mirroring the reference (`python/seldon_core/metrics.py:60-89`):
    a list of {key: str, type: COUNTER|GAUGE|TIMER, value: number}."""
    if not isinstance(metrics, (list, tuple)):
        return False
    for m in metrics:
        if not isinstance(m, dict):
            return False
        if not isinstance(m.get("key"), str):
            return False
        if m.get("type") not in _METRIC_TYPES:
            return False
        v = m.get("value")
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return False
    return True


class SeldonComponent:
    """Base class for graph components (models, routers, transformers, combiners)."""

    def __init__(self, **kwargs: Any):
        pass

    # -- lifecycle ------------------------------------------------------
    def load(self) -> None:
        """Load model artifacts; called once before serving."""

    # -- MODEL ----------------------------------------------------------
    def predict(
        self, X: np.ndarray, names: Sequence[str], meta: Optional[Dict] = None
    ) -> Union[np.ndarray, List, str, bytes]:
        raise NotImplementedError

    def predict_raw(self, msg: SeldonMessage) -> Union[SeldonMessage, Dict, np.ndarray, str, bytes]:
        raise NotImplementedError

    # -- TRANSFORMER ----------------------------------------------------
    def transform_input(
        self, X: np.ndarray, names: Sequence[str], meta: Optional[Dict] = None
    ) -> Union[np.ndarray, List, str, bytes]:
        raise NotImplementedError

    def transform_input_raw(self, msg: SeldonMessage) -> Union[SeldonMessage, Dict, np.ndarray, str, bytes]:
        raise NotImplementedError

    def transform_output(
        self, X: np.ndarray, names: Sequence[str], meta: Optional[Dict] = None
    ) -> Union[np.ndarray, List, str, bytes]:
        raise NotImplementedError

    def transform_output_raw(self, msg: SeldonMessage) -> Union[SeldonMessage, Dict, np.ndarray, str, bytes]:
        raise NotImplementedError

    # -- ROUTER ---------------------------------------------------------
    def route(self, X: np.ndarray, names: Sequence[str]) -> int:
        raise NotImplementedError

    def route_raw(self, msg: SeldonMessage) -> Union[SeldonMessage, Dict, int]:
        raise NotImplementedError

    # -- COMBINER -------------------------------------------------------
    def aggregate(
        self, Xs: Sequence[np.ndarray], names: Sequence[Sequence[str]]
    ) -> Union[np.ndarray, List, str, bytes]:
        raise NotImplementedError

    def aggregate_raw(self, msgs: Sequence[SeldonMessage]) -> Union[SeldonMessage, Dict, np.ndarray]:
        raise NotImplementedError

    # -- FEEDBACK -------------------------------------------------------
    def send_feedback(
        self,
        features: np.ndarray,
        feature_names: Sequence[str],
        reward: float,
        truth: Optional[np.ndarray],
        routing: Optional[int] = None,
    ) -> Optional[Union[np.ndarray, List]]:
        raise NotImplementedError

    def send_feedback_raw(self, feedback: Feedback) -> Union[SeldonMessage, Dict, None]:
        raise NotImplementedError

    # -- enrichment -----------------------------------------------------
    def tags(self) -> Dict[str, Any]:
        raise NotImplementedError

    def metrics(self) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def feature_names(self) -> List[str]:
        raise NotImplementedError

    def class_names(self) -> List[str]:
        raise NotImplementedError

    # -- fusion hook ----------------------------------------------------
    def torch_fn(self) -> Optional[Tuple[Callable[..., Any], Any]]:
        """``(fn, params)`` where ``fn(params, x)`` takes and returns a
        tensor on the component's device, or None. Lets the graph engine
        run this unit inside one composed function with its neighbours."""
        return None


# ---------------------------------------------------------------------------
# client_* helpers: tolerant invocation with graceful fallbacks, the
# capability of `python/seldon_core/user_model.py:94-331`.
# ---------------------------------------------------------------------------

_IMPL_CACHE: Dict[Any, bool] = {}


def _has_impl(obj: Any, name: str) -> bool:
    """True if obj defines `name` itself (not the NotImplementedError base
    stub). Class-level answers are cached — this runs several times per
    request on the serving path, and the reflection chain costs more than
    the rest of the meta assembly. Instance-level overrides (obj.tags = fn)
    bypass the cache."""
    d = getattr(obj, "__dict__", None)
    if d is not None and name in d:
        return callable(d[name])
    cls = type(obj)
    key = (cls, name)
    hit = _IMPL_CACHE.get(key)
    if hit is None:
        meth = getattr(cls, name, None)
        if meth is None or not callable(meth):
            hit = False
        else:
            base = getattr(SeldonComponent, name, None)
            hit = not (base is not None and meth is base)
        _IMPL_CACHE[key] = hit
    return hit


def has_raw(obj: Any, name: str) -> bool:
    return _has_impl(obj, name + "_raw")


def client_custom_tags(component: Any) -> Dict[str, Any]:
    if _has_impl(component, "tags"):
        tags = component.tags()
        if tags is not None:
            if not isinstance(tags, dict):
                raise SeldonError("tags() must return a dict")
            return tags
    return {}


def client_custom_metrics(component: Any) -> List[Dict[str, Any]]:
    if _has_impl(component, "metrics"):
        metrics = component.metrics()
        if metrics is not None:
            if not validate_metrics(metrics):
                raise SeldonError(
                    "Bad metrics: must be a list of {key: str, type: COUNTER|GAUGE|TIMER, value: number}"
                )
            return list(metrics)
    return []


def client_feature_names(component: Any, original: Sequence[str]) -> List[str]:
    if _has_impl(component, "feature_names"):
        names = component.feature_names()
        if names is not None:
            return list(names)
    return list(original or [])


def client_class_names(component: Any, predictions: np.ndarray) -> List[str]:
    if _has_impl(component, "class_names"):
        names = component.class_names()
        if names is not None:
            return list(names)
    # Default "t:0..n" naming for 2-D outputs, as the reference does
    # (`user_model.py:94-119`).
    arr = np.asarray(predictions)
    if arr.ndim > 1:
        return [f"t:{i}" for i in range(arr.shape[1])]
    return []


def client_predict(component: Any, X: np.ndarray, names: Sequence[str], meta: Optional[Dict] = None):
    if _has_impl(component, "predict"):
        try:
            return component.predict(X, names, meta=meta)
        except TypeError:
            return component.predict(X, names)
    return []


def client_transform_input(component: Any, X: np.ndarray, names: Sequence[str], meta: Optional[Dict] = None):
    if _has_impl(component, "transform_input"):
        try:
            return component.transform_input(X, names, meta=meta)
        except TypeError:
            return component.transform_input(X, names)
    return X


def client_transform_output(component: Any, X: np.ndarray, names: Sequence[str], meta: Optional[Dict] = None):
    if _has_impl(component, "transform_output"):
        try:
            return component.transform_output(X, names, meta=meta)
        except TypeError:
            return component.transform_output(X, names)
    return X


def client_route(component: Any, X: np.ndarray, names: Sequence[str]) -> int:
    if _has_impl(component, "route"):
        return component.route(X, names)
    return -1


def client_aggregate(component: Any, Xs: Sequence[np.ndarray], names: Sequence[Sequence[str]]):
    if _has_impl(component, "aggregate"):
        return component.aggregate(Xs, names)
    raise SeldonError("Aggregate not defined on component")


def client_send_feedback(
    component: Any,
    features: np.ndarray,
    feature_names: Sequence[str],
    reward: float,
    truth: Optional[np.ndarray],
    routing: Optional[int],
):
    if _has_impl(component, "send_feedback"):
        return component.send_feedback(features, feature_names, reward, truth, routing=routing)
    return None


__all__ = ["SeldonComponent", "client_aggregate", "client_class_names", "client_custom_metrics",
           "client_custom_tags", "client_feature_names", "client_predict", "client_route",
           "client_send_feedback", "client_transform_input", "client_transform_output",
           "has_raw", "validate_metrics"]
