"""The server's programs as CUDA graphs, captured once over fixed buffers
and then replayed: the batcher's (one replay per prefill chunk, one per
decode dispatch: the K-step decode program, or in spec mode the fused draft
+ verify step, and with the prefix cache on one per copy-on-write page
copy) and ``generate()``'s dense decode step (one replay per token).

These are the port's counterparts of the JAX package's compiled programs
(``seldon_core_tpu/servers/llmserver.py``): ``_get_prefill_chunk(chunk,
n_pages)``, one ``jax.jit`` per chunk length, ``_get_decode_step_paged``,
a ``lax.scan`` of k steps under ``jax.jit``, one dispatch per k steps, and
``_get_decode(b, max_len)``, a ``lax.scan`` of ``n_steps`` under
``jax.jit``, of which the port captures one step per (batch bucket,
max_len) and replays it ``n_steps`` times, and ``_get_spec_step``, one
``jax.jit`` per batcher shape, whose per-slot advance (1..K+1 tokens) the
graph computes on the device and the host learns at drain. Eager PyTorch enqueues a
forward's ~2,000 kernels one by one from the host; a replay enqueues the
captured program as one graph launch. The kernels inside are the port's
own (K1 paged attention in the paged decode step, K2 fused residual +
RMSNorm, K4's two int8 GEMM routes), unchanged.

What the capture relies on:

- fixed addresses: a decode step reads and writes the batcher's pools,
  block tables and per-slot state (``last_tok``, ``next_pos``, ``keys``)
  (the dense layout's: its slot pool, which admission prefills in place,
  and the same state),
  a prefill chunk the pools and the batcher's fixed row, token and position
  buffers, the CoW copy the pools and the batcher's fixed ``_cow_args``
  (source page, destination page, valid tokens); the batcher updates all
  of them in place and never rebinds them; the temperature (a 0-dim device
  tensor, or None for greedy) is fixed per batcher; a generate step reads
  and writes the server's dense
  buffer (the contiguous prefix of each flat cache tensor, and the state
  ``tok``, ``pos``, ``done``, ``keys``, ``temperature``), which a growth
  replaces after dropping every generate graph; a spec step also reads and
  writes the batcher's token history ``hist``, its fixed ``draft_cap``
  buffer (written by the host in stream order before each replay) and, in
  draft mode, the dense draft caches; an adapted program (the server has a
  LoRA adapter pool) also reads the pool, whose rows loads and evicts
  write in place (``runtime/adapters.py``), and a fixed id buffer: the
  batcher's per-slot ``_adapter_ids`` [slots] (decode and spec steps) or
  its staged job's ``_chunk_adapter`` [1] (prefill chunks), each written by
  the host in stream order;
- a warm-up run of each program on the capture stream, before any capture,
  does every first-use set-up outside the graph: nvcc builds and library
  loads, the stream's cuBLAS workspace, K1's arrival counters of the stream.
  Every block-table row the warm-up reads is TRASH or NULL (a new batcher's
  are; the prefill row is reset here), so it writes only the TRASH page;
  the slot state is restored after it;
- every kernel wrapper launches on the current stream (the capture stream
  while capturing); what a program allocates comes from the graph's pool
  (the prefill graphs share one, the decode graphs have one each), and
  K4's TMA descriptors, encoded on the host at capture, hold addresses in
  that pool and in the fixed weights;
- the capture is thread-local (``capture_error_mode="thread_local"``):
  other threads (REST requests on the private ``generate()`` path) may
  launch work meanwhile;
- the wrappers count launches in Python, which a replay does not run: a
  capture records the kernels and launches none, so its thread counts
  them into the capture's own tally (``ops/launches.tally``), and each
  replay adds the tally. Launches of other threads meanwhile (a batcher
  replaying while a REST thread captures) stay out of it;
- cuBLAS binds one workspace per (thread's handle, stream), so graphs a
  thread captures on the server's stream share one workspace: replay them
  one at a time, as one batcher does on its one stream (a server serves
  one batcher, ``runtime/batcher.get_batcher_service``). ``generate()``'s
  graphs are captured on a stream of their own, in one pool of their own,
  and replayed one at a time under the server's ``_dense_lock``, while the
  batcher's thread replays its own; so are each prefill worker's chunk
  graphs (``runtime/disagg.PrefillWorker``: its own thread, stream and
  pool), replayed while the batcher's decode graphs replay.

There is no fallback: a capture that fails raises.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch

from seldon_core_tpu_torch.ops import launches


def launch_counts() -> Dict[Tuple[Any, str], int]:
    """Every kernel wrapper's launch counters: (wrapper, attribute) -> count."""
    from seldon_core_tpu_torch.ops import fused_norm, fused_resnet, int8_matmul, paged_attention

    wrappers = (paged_attention.paged_attention, paged_attention.paged_attention_partial,
                fused_norm.fused_residual_rmsnorm, int8_matmul.int8_matmul,
                fused_resnet.fused_identity_chain)
    return {(fn, name): n for fn in wrappers for name, n in vars(fn).items()
            if name.startswith("launches")}


class ReplayGraph:
    """One captured program. ``replay()`` launches it on the current
    stream, adds the launch counts its capture saw, and returns its output
    buffer (a decode step's tokens [slots, k], a prefill chunk's logits [1,
    chunk, vocab]; None for the in-place CoW copy); the next replay of
    this graph, or of another graph sharing its memory pool, overwrites
    that buffer, so read it in stream order before then."""

    def __init__(self, graph: torch.cuda.CUDAGraph, out: Optional[torch.Tensor],
                 counts: Dict[Tuple[Any, str], int], capture_s: float = 0.0):
        self.graph = graph
        self.out = out
        self.counts = counts
        self.capture_s = capture_s   # host time of the capture and instantiation

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        launches.add(self.counts)
        return self.out


@contextlib.contextmanager
def _on_capture_stream(stream: torch.cuda.Stream, device: torch.device) -> Iterator[None]:
    """Run the body on ``stream`` (a server's capture stream), ordered
    after the current stream's work, and order the current stream after
    the body's. One stream for every batcher capture keeps cuBLAS on one
    workspace, and K1's arrival counters of that stream are set up by the
    warm-up, outside the graphs (module docstring)."""
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


def _capture(program: Callable[[], torch.Tensor], pool=None) -> ReplayGraph:
    """Capture one call of ``program`` on the current stream (the capture
    stream, after a warm-up), thread-locally, in ``pool`` (a fresh pool by
    default). The captured graph is kept beside its executable
    (``raw_cuda_graph()``), so that its kernel nodes can be read back. Its
    launch counts are this thread's tally over the capture. A capture that
    fails raises."""
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with launches.tally() as counts:
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = program()
        except BaseException:
            with contextlib.suppress(RuntimeError):
                graph.capture_end()
            raise
        graph.capture_end()
    graph.instantiate()
    return ReplayGraph(graph, out, counts, time.perf_counter() - t0)


@torch.no_grad()
def capture_decode_steps(server, ks: Sequence[int], pools, last_tok: torch.Tensor,
                         next_pos: torch.Tensor, keys: torch.Tensor,
                         temperature: Optional[torch.Tensor], block_tables: Optional[torch.Tensor],
                         lora: Optional[Dict[str, Any]] = None) -> Dict[int, ReplayGraph]:
    """Capture ``server._get_decode_step_paged(slots, n_pages, k, lora)``
    for each k of ``ks`` over these buffers, on the server's capture stream,
    after a warm-up run of each (module docstring); with ``block_tables``
    None, ``pools`` is the dense batcher's slot pool and the program
    ``server._get_decode_step(slots, width, k, lora)`` (the warm-up writes
    the free slots' rows, which every admission resets). ``lora`` (the
    adapted program's ``adapters`` and ``adapter_ids`` keywords; empty or
    None for the unadapted one). Returns k -> ReplayGraph (its output: the
    tokens [slots, k]). The current stream waits for the capture stream
    before this returns."""
    lora = lora or {}
    slots = last_tok.shape[0]
    if block_tables is None:
        programs = {k: server._get_decode_step(slots, pools.width, k, bool(lora)) for k in ks}
        args = (pools, last_tok, next_pos, keys, temperature)
    else:
        programs = {k: server._get_decode_step_paged(slots, block_tables.shape[1], k, bool(lora))
                    for k in ks}
        args = (pools, last_tok, next_pos, keys, temperature, block_tables)
    state = (last_tok, next_pos, keys)
    graphs = {}
    with _on_capture_stream(server._graph_stream(), last_tok.device):
        saved = [t.clone() for t in state]
        for k in ks:
            programs[k](*args, **lora)
        for t, s in zip(state, saved):
            t.copy_(s)
        for k in ks:
            graphs[k] = _capture(lambda k=k: programs[k](*args, **lora))
    return graphs


@torch.no_grad()
def capture_prefill_chunks(server, chunks: Sequence[int], pools, row: torch.Tensor,
                           tokens: torch.Tensor, positions: torch.Tensor,
                           lora: Optional[Dict[str, Any]] = None,
                           stream: Optional[torch.cuda.Stream] = None) -> Dict[int, ReplayGraph]:
    """Capture ``server._get_prefill_chunk(chunk, n_pages, lora)`` (``lora``:
    the adapted program's keywords, as ``capture_decode_steps``) for each chunk
    length of ``chunks`` over fixed buffers: the pools, the block-table
    row ``row`` [1, n_pages] and the first ``chunk`` columns of ``tokens``
    [1, Cmax] and ``positions`` [1, Cmax] (Cmax >= every chunk), on
    ``stream`` (default: the server's capture stream; a prefill worker
    passes its own, so its replays have a cuBLAS workspace of their own
    beside the batcher's), after a warm-up run of each (module
    docstring). The programs are the ones over the weights on ``row``'s
    device. The buffers are first reset to an all-NULL row, token 0 and
    PAD_POS, so the warm-up writes only the TRASH page. Longest chunk
    first, all in one memory pool: the graphs are replayed one at a time
    on one stream, and each replay's logits are read before the next, so a
    shorter chunk's transients may reuse a longer one's. Returns chunk ->
    ReplayGraph (its output: the logits [1, chunk, vocab]). The current
    stream waits for the capture stream before this returns."""
    from seldon_core_tpu_torch.models.transformer import NULL_PAGE, PAD_POS

    lora = lora or {}
    n_pages = row.shape[1]
    order = sorted(chunks, reverse=True)
    programs = {c: server._get_prefill_chunk(c, n_pages, bool(lora), device=row.device)
                for c in order}
    args = {c: (pools, row, tokens[:, :c], positions[:, :c]) for c in order}
    graphs = {}
    with _on_capture_stream(stream or server._graph_stream(), row.device):
        row.fill_(NULL_PAGE)
        tokens.zero_()
        positions.fill_(PAD_POS)
        for c in order:
            programs[c](*args[c], **lora)
        pool = torch.cuda.graph_pool_handle()
        for c in order:
            graphs[c] = _capture(lambda c=c: programs[c](*args[c], **lora), pool)
    return graphs


@torch.no_grad()
def capture_generate_step(server, b: int, max_len: int, caches, tok: torch.Tensor,
                          pos: torch.Tensor, done: torch.Tensor, keys: torch.Tensor,
                          temperature: torch.Tensor, pool) -> ReplayGraph:
    """Capture ``server._get_decode(b, max_len)``, ``generate()``'s dense
    decode step, over the dense buffer's views (``caches``, the state
    ``tok``, ``pos``, ``done``, ``keys`` and the 0-dim ``temperature``), on
    the server's generate stream, in ``pool`` (shared by every generate
    graph: they replay one at a time, and each replay's tokens are copied
    out in stream order before the next). A warm-up run first, then the
    state restored; the warm-up's cache write at each row's ``pos`` is the
    one the first replay makes again. Returns the ReplayGraph (its output:
    the tokens [b]). The current stream waits for the capture stream before
    this returns."""
    program = server._get_decode(b, max_len)
    args = (caches, tok, pos, done, keys, temperature)
    state = (tok, pos, done, keys)
    with _on_capture_stream(server._generate_stream(), tok.device):
        saved = [t.clone() for t in state]
        program(*args)
        for t, s in zip(state, saved):
            t.copy_(s)
        graph = _capture(lambda: program(*args), pool)
    return graph


@torch.no_grad()
def capture_spec_step(server, spec_k: int, mode: str, pools, last_tok: torch.Tensor,
                      next_pos: torch.Tensor, keys: torch.Tensor,
                      temperature: Optional[torch.Tensor], block_tables: Optional[torch.Tensor],
                      hist: torch.Tensor, draft_cap: torch.Tensor, draft_caches=None,
                      lora: Optional[Dict[str, Any]] = None) -> ReplayGraph:
    """Capture ``server._get_spec_step(slots, spec_k, hist_len, mode=mode,
    n_pages=...)`` over the batcher's fixed buffers (the pools, the slot
    state, the block tables, ``hist`` [slots, hist_len + 1], ``draft_cap``
    [slots] and in draft mode the dense draft caches) on the server's
    capture stream, in a pool of its own, after a warm-up run with
    ``draft_cap`` zero (module docstring); with ``block_tables`` None the
    step of ``layout="dense"`` over the slot pool ``pools``. The warm-up
    reads all-TRASH block tables, so it writes only the TRASH page (over a
    slot pool: the free slots' rows, which admission resets); the slot state and
    ``hist`` are restored after it, and the draft caches reset (every
    admission rewrites its slot's row). Returns the ReplayGraph (its
    output: [slots, spec_k + 2], the tokens and, last, the advance). The
    current stream waits for the capture stream before this returns.
    ``lora``: the adapted verify's keywords, as ``capture_decode_steps``."""
    from seldon_core_tpu_torch.models.transformer import reset_kv_caches

    lora = lora or {}
    slots = last_tok.shape[0]
    n_pages = 0 if block_tables is None else block_tables.shape[1]
    program = server._get_spec_step(slots, spec_k, hist.shape[1] - 1, mode=mode,
                                    layout="dense" if block_tables is None else "paged",
                                    n_pages=n_pages, lora=bool(lora))
    args = (pools, last_tok, next_pos, keys, temperature, block_tables, hist, draft_cap,
            draft_caches)
    state = (last_tok, next_pos, keys, hist)
    with _on_capture_stream(server._graph_stream(), last_tok.device):
        saved = [t.clone() for t in state]
        draft_cap.zero_()
        program(*args, **lora)
        for t, s in zip(state, saved):
            t.copy_(s)
        if draft_caches is not None:
            reset_kv_caches(draft_caches)
        graph = _capture(lambda: program(*args, **lora))
    return graph


@torch.no_grad()
def capture_cow_copy(server, pools, args: torch.Tensor) -> ReplayGraph:
    """Capture ``runtime/batcher.cow_page_copy`` over the pools and the
    batcher's fixed ``args`` [3] int64 (source page, destination page, valid
    tokens: the host stages them in stream order before each replay), on
    the server's capture stream, in a pool of its own (one page's
    transients), after a warm-up run. ``args`` is set to (TRASH, TRASH, 0)
    first, so the warm-up only rewrites the TRASH page. Eager, the copy is
    a few launches a layer of host enqueue; a replay is one graph launch.
    Returns the ReplayGraph (no output: the copy is in place). The current
    stream waits for the capture stream before this returns."""
    from seldon_core_tpu_torch.models.transformer import TRASH_PAGE
    from seldon_core_tpu_torch.runtime.batcher import cow_page_copy

    def program():
        cow_page_copy(pools, args[0:1], args[1:2], args[2:3], server._module)

    with _on_capture_stream(server._graph_stream(), args.device):
        args.fill_(TRASH_PAGE)
        args[2:].zero_()
        program()
        graph = _capture(program)
    return graph


__all__ = ["ReplayGraph", "capture_cow_copy", "capture_decode_steps", "capture_generate_step",
           "capture_prefill_chunks", "capture_spec_step", "launch_counts"]
