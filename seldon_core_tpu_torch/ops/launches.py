"""The kernel wrappers' launch counters: attributes of each wrapper function
(``fused_residual_rmsnorm.launches``, ``int8_matmul.launches_wgmma`` ...).
A wrapper adds to its counter through ``count`` where it launches its
kernel, and nowhere else.

A CUDA graph capture records the kernels and launches none. While a thread
captures (inside ``tally()``), its wrappers' counts go to that capture's
tally, which each replay of the graph adds (``add``; see
``servers/step_graph.ReplayGraph``). What other threads launch meanwhile,
a batcher thread replaying while a REST thread captures, goes to the
counters as always and never into the tally. Every addition to a counter
holds one lock, so concurrent threads lose none."""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, Tuple

Counter = Tuple[Any, str]   # (wrapper function, attribute)

_lock = threading.Lock()
_local = threading.local()


def add(counts: Dict[Counter, int]) -> None:
    """Add each ``n`` of ``counts`` to its counter."""
    with _lock:
        for (fn, name), n in counts.items():
            setattr(fn, name, getattr(fn, name) + n)


def count(fn, name: str = "launches", n: int = 1) -> None:
    """Count ``n`` launches of the wrapper ``fn`` under ``name``: into the
    capture's tally while this thread captures a graph, else into the
    counter."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally[fn, name] = tally.get((fn, name), 0) + n
    else:
        add({(fn, name): n})


@contextlib.contextmanager
def tally() -> Iterator[Dict[Counter, int]]:
    """This thread's launches inside the block, counted into the dict it
    yields and not into the counters."""
    outer = getattr(_local, "tally", None)
    _local.tally = counts = {}
    try:
        yield counts
    finally:
        _local.tally = outer


__all__ = ["add", "count", "tally"]
