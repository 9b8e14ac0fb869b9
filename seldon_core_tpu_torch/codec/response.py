"""Response construction: the port of ``seldon_core_tpu/codec/response.py``.
Turns a component's raw return value into a SeldonMessage, mirroring the
reference's type rules
(`python/seldon_core/utils.py:410-469`):

- array/list result: encode following the request's DefaultData encoding when
  numeric (tensor->tensor, ndarray->ndarray), else ndarray; if the request was
  not DefaultData, numeric results become tensor, non-numeric ndarray.
- str -> strData, bytes -> binData, dict -> jsonData.
- names: feature_names() on the request flow, class_names() on the response
  flow (default "t:i" for 2-D numeric outputs).
- meta carries puid from the request plus component tags() and metrics().

A torch tensor result is treated as the JAX package treats a ``jax.Array``:
copied to the host as a numpy array (a bfloat16 tensor as float32, which
numpy can hold).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from seldon_core_tpu_torch.components.component import (
    client_class_names,
    client_custom_metrics,
    client_custom_tags,
    client_feature_names,
)
from seldon_core_tpu_torch.contracts.payload import (
    ENC_NDARRAY,
    ENC_TENSOR,
    DefaultData,
    Meta,
    Metric,
    SeldonError,
    SeldonMessage,
)


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def response_meta(component: Any, request_meta: Optional[Meta]) -> Meta:
    meta = Meta()
    if request_meta is not None and request_meta.puid:
        meta.puid = request_meta.puid
    tags = client_custom_tags(component)
    if tags:
        meta.tags.update(tags)
    for m in client_custom_metrics(component):
        meta.metrics.append(Metric.from_dict(m))
    return meta


def construct_response(
    component: Any,
    is_request: bool,
    request: Optional[SeldonMessage],
    raw_result: Any,
) -> SeldonMessage:
    """Build the response SeldonMessage from a component's raw return value."""
    if isinstance(raw_result, SeldonMessage):
        if not raw_result.meta.puid and request is not None and request.meta.puid:
            raw_result.meta.puid = request.meta.puid
        return raw_result

    meta = response_meta(component, request.meta if request is not None else None)

    if isinstance(raw_result, (bytes, bytearray)):
        return SeldonMessage(meta=meta, bin_data=bytes(raw_result), which="binData")
    if isinstance(raw_result, str):
        return SeldonMessage(meta=meta, str_data=raw_result, which="strData")
    if isinstance(raw_result, dict):
        return SeldonMessage(meta=meta, json_data=raw_result, which="jsonData")

    if isinstance(raw_result, torch.Tensor):
        arr = _tensor_to_numpy(raw_result)
    elif isinstance(raw_result, np.ndarray):
        arr = raw_result
    elif isinstance(raw_result, (list, tuple)):
        arr = np.asarray(raw_result)
    elif np.isscalar(raw_result):
        arr = np.asarray(raw_result)
    else:
        raise SeldonError(
            f"Unknown data type returned as payload (must be array, list, str, bytes or dict): "
            f"{type(raw_result).__name__}"
        )

    numeric = np.issubdtype(arr.dtype, np.number) or arr.dtype == np.bool_
    if request is not None and request.which == "data" and request.data is not None:
        encoding = request.data.encoding if numeric else ENC_NDARRAY
    else:
        encoding = ENC_TENSOR if numeric else ENC_NDARRAY

    if is_request:
        req_names: Sequence[str] = request.names if request is not None else []
        names = client_feature_names(component, req_names)
    else:
        names = client_class_names(component, arr)

    data = DefaultData(names=names, array=arr if numeric else None, encoding=encoding)
    if not numeric:
        data.raw_ndarray = arr.tolist()
    return SeldonMessage(meta=meta, data=data, which="data")


__all__ = ["construct_response", "response_meta"]
