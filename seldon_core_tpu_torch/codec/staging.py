"""Device staging: move request payloads onto the card as torch tensors.

Port of ``seldon_core_tpu/codec/staging.py``. Ingress decodes once and
stages the array on the device the model runs on. Batch bucketing pads the
leading dim up to the next bucket, so a small fixed set of batch shapes
serves all traffic (cuDNN picks and caches its algorithms per shape).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def bucket_size(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n; grows by doubling past the last bucket."""
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1]
    while b < n:
        b *= 2
    return b


def pad_batch(arr: np.ndarray, buckets: Sequence[int] = DEFAULT_BUCKETS) -> Tuple[np.ndarray, int]:
    """Pad the leading (batch) dim up to its bucket. Returns (padded, true_n)."""
    n = arr.shape[0] if arr.ndim else 1
    target = bucket_size(n, buckets)
    if target == n:
        return arr, n
    pad_width = [(0, target - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width), n


def stage_to_device(arr: np.ndarray, device, dtype: Optional[np.dtype] = None,
                    pad: bool = False,
                    buckets: Sequence[int] = DEFAULT_BUCKETS) -> Tuple[torch.Tensor, int]:
    """numpy -> a torch tensor on ``device`` (a CUDA copy is pinned and
    asynchronous). Returns (tensor, true_batch); with ``pad=True`` the
    leading dim is bucketed first."""
    true_n = arr.shape[0] if arr.ndim else 1
    if pad:
        arr, true_n = pad_batch(arr, buckets)
    if dtype is not None:
        arr = arr.astype(dtype, copy=False)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True), true_n
    return t.to(device), true_n


__all__ = ["DEFAULT_BUCKETS", "bucket_size", "pad_batch", "stage_to_device"]
