"""In-process inference-graph engine of the port: ``seldon_core_tpu/runtime/
engine.py``'s ``GraphEngine`` over local nodes.

The reference orchestrator's graph semantics
(`engine/src/main/java/io/seldon/engine/predictors/PredictiveUnitBean.java:81-237`):

    per node: transformInput -> route (-1 = all children) -> children ->
              aggregate -> transformOutput
    meta: merge tags, accumulate metrics, record routing + requestPath
    feedback: deliver to the node, then replay only down the routed branch

Every node is a direct call in this process, and the graph is built once,
not per request. A router-free subtree of two or more units whose
components all expose ``torch_fn()`` is composed into one function on the
engine's device (``_try_fuse``): the request's array is staged to the
device once, the children's outputs are stacked and reduced there, and
the result comes back to the host once. ``_fused_calls`` counts its runs.

A graph of local synchronous nodes is driven without an event loop
(``predict_sync``); one that has an asynchronous component runs on
``asyncio``. Remote nodes (a unit with an ``endpoint``) and replica sets (a
list of components under one name) come with the remote-node slice of the
port and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import secrets
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.codec.response import response_meta
from seldon_core_tpu_torch.codec.staging import stage_to_device
from seldon_core_tpu_torch.components import dispatch
from seldon_core_tpu_torch.components.builtin import make_builtin
from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.graph import (PredictiveUnit, PredictorSpec,
                                                   UnitImplementation, UnitMethod, UnitType)
from seldon_core_tpu_torch.contracts.payload import (Feedback, Meta, SeldonError, SeldonMessage,
                                                     SeldonMessageList)
from seldon_core_tpu_torch.device import resolve_device
from seldon_core_tpu_torch.runtime.resilience import (BreakerOpen, CircuitBreaker, Deadline,
                                                      ResilienceConfig, current_deadline,
                                                      deadline_scope, failure_counts_for_breaker)
from seldon_core_tpu_torch.tracing import get_tracer

logger = logging.getLogger(__name__)

TAG_PARTIAL_RESPONSE = "seldon.io/partial-response"
TAG_DROPPED_BRANCHES = "seldon.io/dropped-branches"
TAG_REROUTED = "seldon.io/rerouted"

REMOTE_SLICE = "the remote-node slice of the port (ROADMAP Queue A item 3b)"

class _Suspended(Exception):
    """A graph coroutine suspended on real async work although
    ``has_async_nodes`` is False: the detection missed an async component
    (a sync method returning an awaitable, an async ``__call__``). Callers
    degrade to the event-loop path."""


def _drive_sync(coro):
    """Run a coroutine that never truly suspends (every await is another
    such coroutine) to its end without an event loop."""
    try:
        coro.send(None)
    except StopIteration as stop:
        return stop.value
    coro.close()
    raise _Suspended()


_METHODS = ("predict", "transform_input", "transform_output", "route", "aggregate",
            "send_feedback", "predict_raw", "transform_input_raw", "transform_output_raw",
            "route_raw", "aggregate_raw", "send_feedback_raw")


def _is_async_component(comp) -> bool:
    """Does this component suspend for real (the ``is_async`` marker, or
    any ``async def`` method)?"""
    if comp is None:
        return False
    if getattr(comp, "is_async", False):
        return True
    return any(inspect.iscoroutinefunction(getattr(comp, name, None)) for name in _METHODS)


def make_puid() -> str:
    """Request id of the reference's SecureRandom 130-bit class
    (`service/PredictionService.java:77-83`)."""
    return secrets.token_hex(16)


@dataclass
class UnitState:
    """Built state of one graph node: its component and children, made
    once at engine build (`engine/.../PredictiveUnitState.java:37-125`)."""

    name: str
    unit: PredictiveUnit
    component: Optional[SeldonComponent]
    children: List["UnitState"] = field(default_factory=list)
    image: str = ""
    # built only for asynchronous nodes: a local call cannot fail apart
    # from this process
    breaker: Optional[CircuitBreaker] = None
    # set when this node's whole subtree runs as one composed function:
    # it takes the request's host array and returns a device tensor
    fused_fn: Optional[Callable[[np.ndarray], torch.Tensor]] = None
    # every unit fused_fn covers, and the component whose class_names and
    # encoding rules own the response (the last node of the unfused flow)
    fused_units: List["UnitState"] = field(default_factory=list)
    fused_owner: Optional[SeldonComponent] = None

    @property
    def methods(self) -> List[UnitMethod]:
        return self.unit.resolved_methods()

    def has_method(self, m: UnitMethod) -> bool:
        return m in self.methods


class PredictorState:
    """The built graph of one predictor."""

    def __init__(self, spec: PredictorSpec, root: UnitState):
        self.spec = spec
        self.root = root

    def walk(self):
        stack = [self.root]
        while stack:
            s = stack.pop()
            yield s
            stack.extend(s.children)

    def unit_by_name(self, name: str) -> Optional[UnitState]:
        for s in self.walk():
            if s.name == name:
                return s
        return None


class GraphEngine:
    """Builds and runs a predictor graph on ``device`` (default "cuda":
    raises without a card; "cpu" only when asked).

    components: name -> a live component for a user node.
    A ``JAX_SERVER`` unit with a ``modelUri`` becomes a ``TorchServer`` on
    the engine's device.
    """

    def __init__(self, spec: PredictorSpec, components: Optional[Dict[str, SeldonComponent]] = None,
                 fuse: bool = True,
                 annotations: Optional[Dict[str, str]] = None,
                 resilience: Optional[ResilienceConfig] = None, device: Optional[str] = None):
        self.spec = spec
        self.device = resolve_device(device)
        self._components = dict(components or {})
        self._fuse = fuse
        self._annotations = dict(annotations or {})
        self.resilience = resilience or ResilienceConfig.from_annotations(self._annotations)
        self._fused_calls = 0
        self._fused_lock = threading.Lock()
        self.state = self._build(spec)
        if fuse:
            self._try_fuse(self.state.root)
        # a graph of local synchronous nodes never truly suspends: its
        # coroutines run to their end without an event loop
        self.has_async_nodes = any(_is_async_component(s.component) for s in self.state.walk())
        for s in self.state.walk():
            if _is_async_component(s.component):
                s.breaker = self.resilience.make_breaker(s.name)

    def breakers(self) -> List[Tuple[str, CircuitBreaker]]:
        """(node name, breaker) of every breaker-wrapped node, sorted."""
        out = [(s.name, s.breaker) for s in self.state.walk() if s.breaker is not None]
        return sorted(out, key=lambda kv: kv[0])

    # ------------------------------------------------------------------
    # Build
    # ------------------------------------------------------------------
    def _build(self, spec: PredictorSpec) -> PredictorState:
        return PredictorState(spec, self._build_unit(spec.graph))

    def _build_unit(self, unit: PredictiveUnit) -> UnitState:
        component = self._resolve(unit)
        return UnitState(name=unit.name, unit=unit, component=component,
                         children=[self._build_unit(c) for c in unit.children],
                         image=type(component).__name__ if component is not None else "")

    def _resolve(self, unit: PredictiveUnit) -> Optional[SeldonComponent]:
        if unit.name in self._components:
            comp = self._components[unit.name]
            if isinstance(comp, (list, tuple)):
                raise NotImplementedError(
                    f"unit {unit.name!r}: a list of components (replicas behind least-loaded "
                    f"dispatch) arrives with {REMOTE_SLICE}")
        elif unit.implementation is not None and \
                unit.implementation != UnitImplementation.UNKNOWN_IMPLEMENTATION:
            comp = self._make_implementation(unit)
        elif unit.endpoint is not None and unit.endpoint.service_host:
            raise NotImplementedError(f"unit {unit.name!r}: a remote node (endpoint "
                                      f"{unit.endpoint.service_host}:"
                                      f"{unit.endpoint.service_port}) arrives with {REMOTE_SLICE}")
        else:
            raise SeldonError(f"Cannot resolve component for unit {unit.name!r}: no registered "
                              f"component, implementation, or endpoint", reason="BAD_GRAPH",
                              status_code=500)
        if comp is not None and hasattr(comp, "load"):
            comp.load()
        return comp

    def _make_implementation(self, unit: PredictiveUnit) -> SeldonComponent:
        params = unit.parameters_dict()
        try:
            return make_builtin(unit.implementation, params)
        except ValueError:
            pass
        from seldon_core_tpu_torch.servers import make_prepackaged_server

        return make_prepackaged_server(unit.implementation, unit.model_uri, params,
                                       device=str(self.device))

    # ------------------------------------------------------------------
    # Whole-subtree fusion
    # ------------------------------------------------------------------
    def _try_fuse(self, state: UnitState):
        """Bottom-up: when this node and every child are ``torch_fn``
        units and no routing decision is needed, compose the subtree into
        one function. Returns (fn, covered units, owner) or None; only a
        subtree of two or more units gets a ``fused_fn`` (a lone leaf runs
        its own path), but its triple flows up so a parent can fuse it."""
        child_results = [self._try_fuse(c) for c in state.children]
        if (state.component is None or state.has_method(UnitMethod.ROUTE)
                or any(r is None for r in child_results)):
            return None
        hook = getattr(state.component, "torch_fn", None)
        pair = hook() if hook is not None else None
        if pair is None:
            return None
        comp_dev = getattr(state.component, "device", None)
        if comp_dev is not None and torch.device(comp_dev) != self.device:
            raise ValueError(f"unit {state.name!r}: component on {comp_dev}, engine on "
                             f"{self.device}")
        fn, params = pair
        is_combiner = state.has_method(UnitMethod.AGGREGATE)
        if is_combiner and not state.children:
            # a leaf combiner aggregates the singleton [request] on the host
            # path; fn(x) would reduce over the batch dim instead
            return None
        if state.children and not is_combiner and len(state.children) > 1:
            return None  # several children need a combiner to merge them

        if not state.children:
            covered, owner = [state], state.component

            def subtree(x, _fn=fn, _p=params):
                return _fn(_p, x)
        elif is_combiner:
            children = [r[0] for r in child_results]
            covered = [state] + [u for r in child_results for u in r[1]]
            owner = state.component  # the combiner builds the merged response

            def subtree(x, _fn=fn, _p=params, _children=children):
                return _fn(_p, torch.stack([c(x) for c in _children]))
        else:
            # a transformer or model with one child: the child consumes
            # this node's output and owns the response
            child, child_units, owner = child_results[0]
            covered = [state] + child_units

            def subtree(x, _fn=fn, _p=params, _child=child):
                return _child(_fn(_p, x))

        if len(covered) >= 2:
            device = self.device

            def fused(arr: np.ndarray, _subtree=subtree) -> torch.Tensor:
                x, _ = stage_to_device(arr, device, dtype=np.float32)
                with torch.inference_mode():
                    return _subtree(x)

            state.fused_fn = fused
            state.fused_units = covered
            state.fused_owner = owner
            logger.info("fused %d-unit subtree at %s into one function on %s", len(covered),
                        state.name, device)
        return subtree, covered, owner

    # ------------------------------------------------------------------
    # Predict
    # ------------------------------------------------------------------
    async def predict(self, request: SeldonMessage,
                      deadline: Optional[Deadline] = None) -> SeldonMessage:
        if not request.meta.puid:
            request.meta.puid = make_puid()
        puid = request.meta.puid
        # an explicit deadline, else the transport's, else the deployment's
        # default annotation
        if deadline is None:
            deadline = current_deadline()
        if deadline is None and self.resilience.default_deadline_ms:
            deadline = Deadline.from_ms(self.resilience.default_deadline_ms,
                                        clock=self.resilience.clock)
        with deadline_scope(deadline):
            response = await self._get_output(self.state.root, request)
        response.meta.puid = puid
        return response

    def predict_sync(self, request: SeldonMessage) -> SeldonMessage:
        if self.has_async_nodes:
            return asyncio.run(self.predict(request))
        try:
            return _drive_sync(self.predict(request))
        except _Suspended:
            self._degrade_to_async("predict")
            return asyncio.run(self.predict(request))

    def send_feedback_sync(self, feedback: Feedback) -> SeldonMessage:
        if self.has_async_nodes:
            return asyncio.run(self.send_feedback(feedback))
        try:
            return _drive_sync(self.send_feedback(feedback))
        except _Suspended:
            self._degrade_to_async("send_feedback")
            return asyncio.run(self.send_feedback(feedback))

    def _degrade_to_async(self, op: str) -> None:
        """A missed async component: switch the graph to the event-loop
        path for good. The aborted inline attempt already ran every node
        upstream of the suspension, and the retry runs them again: for this
        one request their side effects fire twice."""
        logger.warning("graph suspended on real async work during sync %s despite "
                       "has_async_nodes=False; degrading to the event-loop path. Nodes upstream "
                       "of the suspension re-execute for this request (side effects may fire "
                       "twice, once).", op)
        self.has_async_nodes = True

    def _run_fused(self, state: UnitState, message: SeldonMessage) -> SeldonMessage:
        """The fused subtree: one composed call, and the unfused flow's
        meta (every covered unit's requestPath entry, tags and metrics; the
        flow-final component owns the payload)."""
        out = state.fused_fn(message.data.to_numpy())
        with self._fused_lock:
            self._fused_calls += 1
        resp = dispatch.construct_response(state.fused_owner, False, message, out)
        self._merge_meta(resp, message.meta)
        for unit in state.fused_units:
            if unit.component is not state.fused_owner:
                self._merge_meta(resp, response_meta(unit.component, None))
            self._record_path(resp, unit)
        return resp

    async def _get_output(self, state: UnitState, message: SeldonMessage) -> SeldonMessage:
        # an exhausted budget stops the subtree before any of its work
        deadline = current_deadline()
        if deadline is not None:
            deadline.check(f"node {state.name}")

        if state.fused_fn is not None and message.which == "data" and message.data is not None:
            return self._run_fused(state, message)

        # 1. transformInput (a MODEL's is predict, `PredictorConfigBean.java:30-107`)
        if state.has_method(UnitMethod.TRANSFORM_INPUT):
            fn = dispatch.predict if state.unit.type == UnitType.MODEL else dispatch.transform_input
            transformed = await self._call(fn, state, message)
            self._merge_meta(transformed, message.meta)
        else:
            transformed = message

        # 2. route
        branch = -1
        if state.has_method(UnitMethod.ROUTE) and state.children:
            route_msg = await self._call(dispatch.route, state, transformed)
            branch = dispatch.extract_route(route_msg)
            if branch >= len(state.children):
                raise SeldonError(f"Router {state.name} returned branch {branch} but unit has "
                                  f"{len(state.children)} children", status_code=500,
                                  reason="BAD_ROUTING")
            if branch >= 0:
                # reroute away from a branch whose subtree has an open breaker
                healthy = self._healthy_branch(state, branch)
                if healthy != branch:
                    logger.warning("router %s: branch %d unavailable (breaker open), rerouting "
                                   "to %d", state.name, branch, healthy)
                    rerouted = dict(transformed.meta.tags.get(TAG_REROUTED) or {})
                    rerouted[state.name] = {"from": branch, "to": healthy}
                    transformed.meta.tags[TAG_REROUTED] = rerouted
                    branch = healthy
            transformed.meta.routing[state.name] = branch
            self._merge_meta(transformed, route_msg.meta, routing_only_tags=True)

        # 3. children
        dropped_branches: List[str] = []
        if state.children and branch == -1:
            allow_partial = (self.resilience.allow_partial
                             and state.has_method(UnitMethod.AGGREGATE)
                             and len(state.children) > 1)
            if self.has_async_nodes:
                results = await asyncio.gather(
                    *[self._get_output(c, transformed) for c in state.children],
                    return_exceptions=allow_partial)
            else:
                # local components are synchronous: gather buys nothing and
                # would need an event loop
                results = []
                for c in state.children:
                    try:
                        results.append(await self._get_output(c, transformed))
                    except SeldonError as e:
                        if not allow_partial:
                            raise
                        results.append(e)
            child_outputs = []
            for child, r in zip(state.children, results):
                if isinstance(r, BaseException):
                    # partial responses drop only branches an open breaker
                    # rejected; a failing node still fails the request
                    if isinstance(r, BreakerOpen):
                        dropped_branches.append(child.name)
                        continue
                    raise r
                child_outputs.append(r)
            if not child_outputs and dropped_branches:
                raise SeldonError(f"combiner {state.name}: every branch dropped by open circuit "
                                  f"breakers ({', '.join(dropped_branches)})", status_code=503,
                                  reason="CIRCUIT_OPEN")
        elif state.children:
            child_outputs = [await self._routed_output(state, branch, transformed)]
        else:
            child_outputs = []

        # 4. aggregate / merge
        if state.has_method(UnitMethod.AGGREGATE):
            if not child_outputs:
                child_outputs = [transformed]
            merged = await self._call(dispatch.aggregate, state,
                                      SeldonMessageList(messages=list(child_outputs)))
            for co in child_outputs:
                self._merge_meta(merged, co.meta)
            if dropped_branches:
                merged.meta.tags[TAG_PARTIAL_RESPONSE] = True
                merged.meta.tags[TAG_DROPPED_BRANCHES] = list(dropped_branches)
        elif len(child_outputs) == 1:
            merged = child_outputs[0]
        elif len(child_outputs) > 1:
            raise SeldonError(f"Unit {state.name} has {len(child_outputs)} child outputs but no "
                              f"COMBINER to aggregate them", status_code=500, reason="BAD_GRAPH")
        else:
            merged = transformed

        # 5. transformOutput
        if state.has_method(UnitMethod.TRANSFORM_OUTPUT):
            out = await self._call(dispatch.transform_output, state, merged)
            self._merge_meta(out, merged.meta)
        else:
            out = merged

        self._record_path(out, state)
        return out

    async def _routed_output(self, state: UnitState, branch: int,
                             message: SeldonMessage) -> SeldonMessage:
        """The routed child's output. A router with an
        ``observe_outcome(branch, latency_s, error)`` hook sees each routed
        request's subtree wall and error on the engine's clock."""
        child = state.children[branch]
        observe = getattr(state.component, "observe_outcome", None)
        if observe is None:
            return await self._get_output(child, message)
        t0 = self.resilience.clock()
        try:
            out = await self._get_output(child, message)
        except asyncio.CancelledError:
            raise  # a client disconnect says nothing about the branch
        except BaseException:
            self._observe_routed(observe, branch, self.resilience.clock() - t0, True)
            raise
        self._observe_routed(observe, branch, self.resilience.clock() - t0, False)
        return out

    @staticmethod
    def _observe_routed(observe, branch: int, latency_s: float, error: bool) -> None:
        try:
            observe(branch, latency_s, error=error)
        except Exception:  # observability must never fail the data path
            logger.exception("router observe_outcome hook failed")

    @staticmethod
    def _subtree_available(state: UnitState) -> bool:
        """Is every breaker of this subtree accepting calls (no probe slot
        consumed)?"""
        stack = [state]
        while stack:
            s = stack.pop()
            if s.breaker is not None and not s.breaker.available():
                return False
            stack.extend(s.children)
        return True

    def _healthy_branch(self, state: UnitState, branch: int) -> int:
        """The routed branch if its subtree is healthy, else the lowest
        healthy sibling; all unhealthy keeps the routed branch."""
        if self._subtree_available(state.children[branch]):
            return branch
        for i, child in enumerate(state.children):
            if i != branch and self._subtree_available(child):
                return i
        return branch

    async def _call(self, fn: Callable, state: UnitState, message: Any) -> SeldonMessage:
        comp = state.component
        if comp is None:
            raise SeldonError(f"Unit {state.name} has no component", status_code=500)
        breaker = state.breaker
        if breaker is not None and not breaker.allow():
            raise BreakerOpen(state.name, breaker.retry_in_s())
        with get_tracer().span(f"node:{state.name}", method=getattr(fn, "__name__", "")):
            try:
                result = fn(comp, message)
                if inspect.isawaitable(result):
                    result = await result
            except BaseException as e:
                # every outcome resolves a half-open probe
                if breaker is not None:
                    if failure_counts_for_breaker(e):
                        breaker.record_failure()
                    elif isinstance(e, asyncio.CancelledError):
                        breaker.release_probe()
                    else:
                        breaker.record_success()
                raise
        if breaker is not None:
            breaker.record_success()
        return result

    @staticmethod
    def _merge_meta(target: SeldonMessage, source: Meta, routing_only_tags: bool = False) -> None:
        """The reference's mergeMeta (`PredictiveUnitBean.java:350-366`):
        tags union (the response wins), routing and requestPath union,
        metrics appended."""
        merged_tags = dict(source.tags)
        merged_tags.update(target.meta.tags)
        target.meta.tags = merged_tags
        for k, v in source.routing.items():
            target.meta.routing.setdefault(k, v)
        for k, v in source.request_path.items():
            target.meta.request_path.setdefault(k, v)
        if not routing_only_tags:
            existing = {id(m) for m in target.meta.metrics}
            for m in source.metrics:
                if id(m) not in existing:
                    target.meta.metrics.append(m)
        if source.puid and not target.meta.puid:
            target.meta.puid = source.puid

    @staticmethod
    def _record_path(msg: SeldonMessage, state: UnitState) -> None:
        msg.meta.request_path[state.name] = state.image

    # ------------------------------------------------------------------
    # Feedback
    # ------------------------------------------------------------------
    async def send_feedback(self, feedback: Feedback) -> SeldonMessage:
        return await self._feedback(self.state.root, feedback)

    async def _feedback(self, state: UnitState, feedback: Feedback) -> SeldonMessage:
        if state.has_method(UnitMethod.SEND_FEEDBACK) and state.component is not None:
            result = dispatch.send_feedback(state.component, feedback, unit_id=state.name)
            if inspect.isawaitable(result):
                await result
        # replay down the routed branch only (`PredictiveUnitBean.java:210-218`)
        if state.children:
            routing = feedback.response.meta.routing if feedback.response is not None else {}
            branch = routing.get(state.name, -1)
            if branch == -1:
                if self.has_async_nodes:
                    await asyncio.gather(*[self._feedback(c, feedback) for c in state.children])
                else:
                    for c in state.children:
                        await self._feedback(c, feedback)
            elif 0 <= branch < len(state.children):
                await self._feedback(state.children[branch], feedback)
            else:
                raise SeldonError(f"Feedback routing for {state.name} names branch {branch} "
                                  f"outside {len(state.children)} children", reason="BAD_ROUTING")
        return SeldonMessage()


__all__ = ["GraphEngine", "PredictorState", "UnitState", "make_puid"]
