"""The paged decode step as a CUDA graph: captured once per batcher over the
batcher's own buffers, replayed once per dispatch.

This is the port's counterpart of the JAX package's compiled step
(``seldon_core_tpu/servers/llmserver.py`` ``_get_decode_step_paged``: a
``lax.scan`` of k steps under ``jax.jit``, one dispatch per k steps). Eager
PyTorch enqueues a step's ~2,000 kernels one by one from the host; a replay
enqueues the captured k steps as one graph launch. The kernels inside are
the port's own (K1 paged attention, K2 fused residual + RMSNorm, K4's decode
GEMM), unchanged.

What the capture relies on:

- fixed addresses: the step reads and writes the batcher's pools, block
  tables and per-slot state (``last_tok``, ``next_pos``, ``keys``), which the
  step and the batcher update in place and never rebind; the temperature is
  a constant of the capture (fixed per batcher);
- a warm-up run of each program on the capture stream, before any capture,
  does every first-use set-up outside the graph: nvcc builds and library
  loads, the stream's cuBLAS workspace, K1's arrival counters of the stream.
  The caller guarantees every block-table row is TRASH (a new batcher's
  are), so the warm-up writes only the TRASH page; the slot state is
  restored after it;
- every kernel wrapper launches on the current stream (the capture stream
  while capturing); what the step allocates comes from the graph's pool;
- the capture is thread-local (``capture_error_mode="thread_local"``):
  other threads (REST requests on the private ``generate()`` path) may
  launch work meanwhile;
- the wrappers count launches in Python, which a replay does not run, so a
  replay adds the counts its capture saw;
- cuBLAS binds one workspace per (thread's handle, stream), so graphs a
  thread captures on the server's stream share one workspace: replay them
  one at a time, as one batcher does on its one stream (a server serves
  one batcher, ``runtime/batcher.get_batcher_service``).

There is no fallback: a capture that fails raises.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Sequence, Tuple

import torch


def launch_counts() -> Dict[Tuple[Any, str], int]:
    """Every kernel wrapper's launch counters: (wrapper, attribute) -> count."""
    from seldon_core_tpu_torch.ops import fused_norm, fused_resnet, int8_matmul, paged_attention

    wrappers = (paged_attention.paged_attention, fused_norm.fused_residual_rmsnorm,
                int8_matmul.int8_matmul, fused_resnet.fused_identity_chain)
    return {(fn, name): n for fn in wrappers for name, n in vars(fn).items()
            if name.startswith("launches")}


class StepGraph:
    """One captured program of ``k`` decode steps. ``replay()`` launches it
    on the current stream, adds the launch counts its capture saw, and
    returns its tokens buffer [slots, k]; the next replay overwrites that
    buffer, so copy it out in stream order before then."""

    def __init__(self, graph: torch.cuda.CUDAGraph, tokens: torch.Tensor, k: int,
                 counts: List[Tuple[Tuple[Any, str], int]]):
        self.graph = graph
        self.tokens = tokens
        self.k = k
        self.counts = counts

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        for (fn, name), n in self.counts:
            setattr(fn, name, getattr(fn, name) + n)
        return self.tokens


@torch.no_grad()
def capture_decode_steps(server, ks: Sequence[int], pools, last_tok: torch.Tensor,
                         next_pos: torch.Tensor, keys: torch.Tensor, temperature: float,
                         block_tables: torch.Tensor) -> Dict[int, StepGraph]:
    """Capture ``server._get_decode_step_paged(slots, n_pages, k)`` for each
    k of ``ks`` over these buffers, on the server's capture stream, after a
    warm-up run of each (module docstring). Returns k -> StepGraph. The
    current stream waits for the capture stream before this returns."""
    slots, n_pages = block_tables.shape
    programs = {k: server._get_decode_step_paged(slots, n_pages, k) for k in ks}
    args = (pools, last_tok, next_pos, keys, temperature, block_tables)
    state = (last_tok, next_pos, keys)
    stream = server._graph_stream()
    current = torch.cuda.current_stream(last_tok.device)
    stream.wait_stream(current)
    graphs = {}
    with torch.cuda.stream(stream):
        saved = [t.clone() for t in state]
        for k in ks:
            programs[k](*args)
        for t, s in zip(state, saved):
            t.copy_(s)
        for k in ks:
            before = launch_counts()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                tokens = programs[k](*args)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
            counts = [(key, n - before[key]) for key, n in launch_counts().items()
                      if n != before[key]]
            graphs[k] = StepGraph(graph, tokens, k, counts)
    current.wait_stream(stream)
    return graphs


__all__ = ["StepGraph", "capture_decode_steps", "launch_counts"]
