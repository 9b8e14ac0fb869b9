"""Small shared helpers of the port, copied from ``seldon_core_tpu/utils.py``."""

from __future__ import annotations

from typing import Sequence


def bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; beyond the largest bucket, round up to a
    multiple of it (a bounded set of shapes) instead of truncating: any
    hard cap (model context, cache length) is applied by callers. The one
    bucketing policy for prompt lengths (servers/llmserver.py) and detector
    window counts (analytics/outliers.py)."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top
