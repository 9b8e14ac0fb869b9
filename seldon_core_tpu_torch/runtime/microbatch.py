"""Cross-request micro-batching of the port, for row-wise predictor graphs:
``seldon_core_tpu/runtime/microbatch.py``'s ``MicroBatcher``.

Concurrent predict requests coalesce into one batch, so the card runs one
large forward instead of many small ones. The graph must be row-wise: every
component maps row i of its input to row i of its output (MODELs,
TRANSFORMERs and COMBINERs do; a ROUTER does not, because one routing
decision for a merged batch would send every caller's rows down one
branch), and the constructor refuses a graph with a router.

Requests group by ``(shape[1:], dtype, which, names)``: rows concatenate
only where the non-batch dimensions, dtype, payload form and feature names
agree (the first request's names label the merged batch). A group flushes
when it holds ``max_batch`` rows, or once its oldest request has waited
``max_delay_ms``. Its answer is split back by each request's row count,
each with its own puid; an engine error reaches every caller of the group.
A payload that is not an array passes through alone.

Two entry points over one set of rules: ``predict`` for an event loop (the JAX
package's), and ``predict_sync`` for the port's threaded transports
(``transport/rest.make_engine_app``, ``grpc_server.make_engine_server``,
which call ``predict_sync`` on each request's thread): a request thread
waits on a ``concurrent.futures.Future``, the thread that fills a group
flushes it, and one flusher thread flushes groups whose delay ran out.
Merged batches run with no deadline: one request's budget must not govern
the others' rows.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from seldon_core_tpu_torch.contracts.graph import UnitMethod
from seldon_core_tpu_torch.contracts.payload import SeldonError, SeldonMessage
from seldon_core_tpu_torch.runtime.resilience import deadline_scope

logger = logging.getLogger(__name__)


class _Pending:
    __slots__ = ("msg", "rows", "future", "t0")

    def __init__(self, msg: SeldonMessage, rows: np.ndarray, future):
        self.msg = msg
        self.rows = rows
        self.future = future
        self.t0 = time.monotonic()


def _graph_is_rowwise(spec) -> Tuple[bool, str]:
    stack = [spec.graph]
    while stack:
        unit = stack.pop()
        if UnitMethod.ROUTE in unit.resolved_methods():
            return False, f"unit {unit.name!r} routes per request"
        stack.extend(unit.children)
    return True, ""


def _rows_of(request: SeldonMessage) -> Optional[np.ndarray]:
    """The request's rows, or None for a payload that passes through."""
    payload = request.payload() if request.data is not None else None
    if not isinstance(payload, np.ndarray) or payload.ndim < 1:
        return None
    return np.atleast_2d(payload)


def _key(request: SeldonMessage, rows: np.ndarray) -> Tuple:
    # names are in the key: requests with different feature names never merge
    return (rows.shape[1:], str(rows.dtype), request.which, tuple(request.names or ()))


def _merged(group: List[_Pending]) -> SeldonMessage:
    names = group[0].msg.names
    return SeldonMessage.from_array(np.concatenate([p.rows for p in group], axis=0),
                                    names=list(names) if names else None)


def _deliver(group: List[_Pending], out: SeldonMessage, set_result, set_exception) -> None:
    """Split ``out`` back by each request's rows, each with its puid."""
    from seldon_core_tpu_torch.runtime.engine import make_puid

    try:
        payload = out.payload()
        n_rows = sum(p.rows.shape[0] for p in group)
        splittable = (isinstance(payload, np.ndarray) and payload.ndim >= 1
                      and payload.shape[0] == n_rows)
        responses, offset = [], 0
        for p in group:
            n = p.rows.shape[0]
            if splittable:
                resp = SeldonMessage.from_array(np.atleast_2d(payload)[offset:offset + n],
                                                names=out.names or None)
                resp.meta = out.meta.copy()
            else:
                # an output that is not row-wise: each caller gets its own
                # copy of the whole response
                resp = SeldonMessage.from_dict(out.to_dict())
            resp.meta.puid = p.msg.meta.puid or make_puid()
            offset += n
            responses.append(resp)
    except Exception as e:
        for p in group:
            set_exception(p.future, e)
        return
    for p, resp in zip(group, responses):
        set_result(p.future, resp)


def _set_result(fut, value) -> None:
    if not fut.done():
        fut.set_result(value)


def _set_exception(fut, exc) -> None:
    if not fut.done():
        fut.set_exception(exc)


class MicroBatcher:
    """Wraps a ``GraphEngine`` with cross-request batching; a drop-in for
    the engine apps (REST and gRPC). ``strict=False`` turns a graph with a
    router into a passthrough instead of refusing it."""

    def __init__(self, engine: Any, max_batch: int = 64, max_delay_ms: float = 2.0,
                 strict: bool = True):
        spec = getattr(engine, "spec", None)
        self._passthrough = False
        if spec is not None:
            ok, why = _graph_is_rowwise(spec)
            if not ok:
                if strict:
                    raise SeldonError(f"MicroBatcher needs a row-wise graph: {why}",
                                      reason="BAD_GRAPH")
                logger.warning("micro-batching disabled: %s", why)
                self._passthrough = True
        self.engine = engine
        self.spec = spec
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self._groups: Dict[Tuple, List[_Pending]] = {}
        self._flusher: Optional[asyncio.Task] = None
        # the thread path's groups and flusher thread
        self._sync_groups: Dict[Tuple, List[_Pending]] = {}
        self._cv = threading.Condition()
        self._sync_flusher: Optional[threading.Thread] = None
        self._count_lock = threading.Lock()
        # merged engine calls, and the requests they carried
        self.batches = 0
        self.batched_requests = 0

    # what the engine apps read besides predict and feedback
    @property
    def device(self):
        return self.engine.device

    @property
    def _components(self):
        return getattr(self.engine, "_components", {})

    def breakers(self):
        return self.engine.breakers() if hasattr(self.engine, "breakers") else []

    def _count(self, group: List[_Pending]) -> None:
        with self._count_lock:
            self.batches += 1
            self.batched_requests += len(group)

    # ------------------------------------------------------------------
    # Event-loop path
    # ------------------------------------------------------------------
    async def predict(self, request: SeldonMessage) -> SeldonMessage:
        if self._passthrough:
            return await self.engine.predict(request)
        rows = _rows_of(request)
        if rows is None:
            return await self.engine.predict(request)
        key = _key(request, rows)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        group = self._groups.setdefault(key, [])
        group.append(_Pending(request, rows, fut))
        if sum(p.rows.shape[0] for p in group) >= self.max_batch:
            await self._flush(key)
        else:
            self._ensure_flusher()
        return await fut

    async def send_feedback(self, feedback) -> SeldonMessage:
        return await self.engine.send_feedback(feedback)

    def _ensure_flusher(self):
        if self._flusher is None or self._flusher.done():
            self._flusher = asyncio.get_running_loop().create_task(self._flush_loop())

    async def _flush_loop(self):
        while self._groups:
            now = time.monotonic()
            for key in [k for k, g in self._groups.items()
                        if g and now - g[0].t0 >= self.max_delay_s]:
                await self._flush(key)
            await asyncio.sleep(self.max_delay_s / 4 if self._groups else 0)

    async def _flush(self, key):
        group = self._groups.pop(key, [])
        if not group:
            return
        if len(group) > 1:
            self._count(group)
        try:
            with deadline_scope(None):
                out = await self.engine.predict(group[0].msg if len(group) == 1
                                                else _merged(group))
        except Exception as e:
            for p in group:
                _set_exception(p.future, e)
            return
        if len(group) == 1:
            _set_result(group[0].future, out)
        else:
            _deliver(group, out, _set_result, _set_exception)

    # ------------------------------------------------------------------
    # Thread path
    # ------------------------------------------------------------------
    def predict_sync(self, request: SeldonMessage) -> SeldonMessage:
        if self._passthrough:
            return self.engine.predict_sync(request)
        rows = _rows_of(request)
        if rows is None:
            return self.engine.predict_sync(request)
        key = _key(request, rows)
        fut: Future = Future()
        with self._cv:
            group = self._sync_groups.setdefault(key, [])
            group.append(_Pending(request, rows, fut))
            full = sum(p.rows.shape[0] for p in group) >= self.max_batch
            if full:
                del self._sync_groups[key]
            else:
                if self._sync_flusher is None:
                    self._sync_flusher = threading.Thread(target=self._sync_flush_loop,
                                                          name="microbatch-flusher",
                                                          daemon=True)
                    self._sync_flusher.start()
                self._cv.notify()
        if full:
            self._run_sync(group)  # the request that fills a group flushes it
        return fut.result()

    def send_feedback_sync(self, feedback) -> SeldonMessage:
        return self.engine.send_feedback_sync(feedback)

    def _sync_flush_loop(self) -> None:
        """Flush each group whose oldest request has waited ``max_delay_ms``;
        end once no group is left (the next request starts a new loop)."""
        while True:
            with self._cv:
                if not self._sync_groups:
                    self._sync_flusher = None
                    return
                now = time.monotonic()
                due = [k for k, g in self._sync_groups.items()
                       if now - g[0].t0 >= self.max_delay_s]
                if not due:
                    wake = min(g[0].t0 for g in self._sync_groups.values()) + self.max_delay_s
                    self._cv.wait(max(wake - now, 0.0))
                    continue
                groups = [self._sync_groups.pop(k) for k in due]
            for group in groups:
                self._run_sync(group)

    def _run_sync(self, group: List[_Pending]) -> None:
        if len(group) > 1:
            self._count(group)
        try:
            with deadline_scope(None):
                out = self.engine.predict_sync(group[0].msg if len(group) == 1
                                               else _merged(group))
        except Exception as e:
            for p in group:
                _set_exception(p.future, e)
            return
        if len(group) == 1:
            _set_result(group[0].future, out)
        else:
            _deliver(group, out, _set_result, _set_exception)


__all__ = ["MicroBatcher"]
