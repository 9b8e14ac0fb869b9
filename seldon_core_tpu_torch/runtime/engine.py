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
``asyncio``, its children fanned out concurrently. A unit with an
``endpoint`` is a remote node (``runtime/remote.RemoteComponent``, an
asynchronous component); a list of components under one name is one
``ReplicaSet``: replicas behind least-loaded, prefix-aware dispatch.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import secrets
import threading
from concurrent.futures import Future
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


def replica_load(component: Any) -> Tuple[float, float]:
    """A replica's load for least-loaded dispatch, from signals the batcher
    already keeps: first the work ahead of a new request (queued requests
    plus occupied or prefilling slots), then the page pool's in-use
    fraction. A component without a batcher scores (0, 0)."""
    svc = getattr(component, "_batcher_service", None)
    if svc is None:
        return (0.0, 0.0)
    from seldon_core_tpu_torch.models.transformer import RESERVED_PAGES

    b = svc.batcher
    queued = len(b._pending) + sum(1 for s in b._slots if s.active or s.prefilling)
    total, in_use, _ = b._allocator.stats()
    return (float(queued), in_use / max(total - RESERVED_PAGES, 1))


class ReplicaSet(SeldonComponent):
    """N identical replicas behind one dispatcher, the JAX package's
    ``ReplicaSet`` (the in-process form of the reference's scaled
    Deployment behind the engine's service). A unit whose registered
    component is a list resolves to one. Each request goes to the replica
    that holds the longest cached prefix of its prompt (``pick_for``), then
    the least loaded (``replica_load``), then the lowest index, so dispatch
    is deterministic under equal load.

    Membership: ``add_replica`` attaches a replica; ``drain_replica`` takes
    one out of dispatch at once while it finishes its queued and in-flight
    work; ``collect_drained`` detaches it (and closes and forgets its
    batcher service) once it has been seen idle on two sweeps in a row, so a request picked just
    before the drain is never closed under. Membership changes under a
    lock; dispatch works on a snapshot.

    The transports reach it as a batcher service (``get_batcher_service``
    returns the fleet itself): ``submit`` picks a replica and joins its
    shared batch. ``llm_stats`` merges the replicas' for the scrape.

    A replica's failure propagates to the caller unchanged, as on a solo
    server: health checks, ejection, the resume journal and the retry
    budget are the fleet fault-tolerance slice (ROADMAP Queue A item 5)."""

    is_fleet = True

    def __init__(self, replicas: List[SeldonComponent]):
        super().__init__()
        if not replicas:
            raise SeldonError("ReplicaSet needs >= 1 replica", status_code=500)
        self.replicas = list(replicas)
        self._draining: List[SeldonComponent] = []
        # replicas seen idle on the previous collect sweep (by id)
        self._idle_once: set = set()
        self._lock = threading.Lock()
        # one collect sweep at a time: two overlapping sweeps would count as
        # two idle sightings an instant apart
        self._collect_guard = threading.Lock()

    # -- membership ------------------------------------------------------
    def members(self) -> List[SeldonComponent]:
        """Every attached replica, draining ones included."""
        with self._lock:
            return list(self.replicas)

    def draining_members(self) -> List[SeldonComponent]:
        with self._lock:
            return list(self._draining)

    def _dispatchable(self) -> List[SeldonComponent]:
        """The replicas dispatch may target: those not draining, or every
        replica when all drain (touching a draining replica beats
        black-holing traffic)."""
        with self._lock:
            live = [r for r in self.replicas if r not in self._draining]
            return live or list(self.replicas)

    def add_replica(self, replica: SeldonComponent) -> None:
        """Attach (and load) one replica; dispatchable at once."""
        if hasattr(replica, "load"):
            replica.load()
        with self._lock:
            self.replicas.append(replica)

    def drain_replica(self, replica: Optional[SeldonComponent] = None
                      ) -> Optional[SeldonComponent]:
        """Start draining ``replica`` (default: the newest serving one, whose
        caches are coldest). Returns it, or None when nothing may drain: the
        last serving replica never does. Its ``drain()`` hook (on it or its
        batcher service), where it has one, is told."""
        with self._lock:
            candidates = [r for r in self.replicas if r not in self._draining]
            if len(candidates) <= 1:
                return None
            if replica is None:
                replica = candidates[-1]
            elif replica not in candidates:
                return None
            self._draining.append(replica)
        hook = self._replica_hook(replica, "drain")
        if hook is not None:
            hook()
        return replica

    def undrain_replica(self) -> Optional[SeldonComponent]:
        """Cancel the newest drain: the warm replica rejoins dispatch.
        Returns it, or None when nothing drains."""
        with self._lock:
            if not self._draining:
                return None
            replica = self._draining.pop()
            self._idle_once.discard(id(replica))
        hook = self._replica_hook(replica, "resume")
        if hook is not None:
            hook()
        return replica

    @staticmethod
    def _replica_hook(replica: SeldonComponent, name: str):
        """``name`` on the replica, else on its batcher service."""
        hook = getattr(replica, name, None)
        if hook is not None:
            return hook
        svc = getattr(replica, "_batcher_service", None)
        return getattr(svc, name, None) if svc is not None else None

    def collect_drained(self) -> List[SeldonComponent]:
        """Detach every draining replica seen idle (its ``is_idle()``, else
        a zero ``replica_load``) on two sweeps in a row, re-checked after
        removal (reattached if a submit landed), and close its batcher
        service. A replica still holding work stays and serves it. A sweep
        that overlaps another returns []."""
        if not self._collect_guard.acquire(blocking=False):
            return []
        try:
            return self._collect_locked()
        finally:
            self._collect_guard.release()

    def _collect_locked(self) -> List[SeldonComponent]:
        done = []
        for r in self.draining_members():
            idle_fn = self._replica_hook(r, "is_idle")

            def idle() -> bool:
                return idle_fn() if idle_fn is not None else replica_load(r) == (0.0, 0.0)

            if not idle():
                with self._lock:
                    self._idle_once.discard(id(r))
                continue
            with self._lock:
                first_sighting = id(r) not in self._idle_once
                self._idle_once.add(id(r))
            if first_sighting:
                continue
            with self._lock:
                if r in self.replicas:
                    self.replicas.remove(r)
                if r in self._draining:
                    self._draining.remove(r)
            if not idle():
                # a submit landed between the check and the removal
                with self._lock:
                    self.replicas.append(r)
                    self._draining.append(r)
                    self._idle_once.discard(id(r))
                continue
            with self._lock:
                self._idle_once.discard(id(r))
            svc = getattr(r, "_batcher_service", None)
            if svc is not None:
                # a replica added back builds a new service on first use
                r._batcher_service = None
                try:
                    svc.close()
                except Exception:  # detaching must not fail the sweep
                    logger.exception("closing a drained replica's batcher")
            done.append(r)
        return done

    def load(self) -> None:
        for r in self.members():
            if hasattr(r, "load"):
                r.load()

    # -- dispatch ----------------------------------------------------------
    def pick(self) -> SeldonComponent:
        """The least-loaded dispatchable replica now (lowest index on ties)."""
        reps = self._dispatchable()
        return min(enumerate(reps), key=lambda ir: (replica_load(ir[1]), ir[0]))[1]

    def _probe(self, prompt: Any, reps: List[SeldonComponent]) -> List[Tuple[int, Tuple]]:
        """Each replica's (cached-prefix length of ``prompt``, load)."""
        out = []
        for r in reps:
            probe = getattr(r, "prefix_match_len", None)
            match = int(probe(prompt)) if probe is not None and prompt is not None else 0
            out.append((match, replica_load(r)))
        return out

    def pick_for(self, prompt: Any) -> SeldonComponent:
        """Prefix-aware dispatch: the replica whose radix cache holds the
        longest cached prefix of ``prompt`` (a hit there costs block-table
        entries where another replica recomputes the prefill), then the
        least loaded, then the lowest index. ``prefix_match_len`` is a
        host-side probe under the replica's own locks."""
        reps = self._dispatchable()
        probes = self._probe(self._encode_once(prompt, reps), reps)
        best = min(range(len(reps)), key=lambda i: (-probes[i][0], probes[i][1], i))
        return reps[best]

    def _encode_once(self, prompt: Any, reps: Optional[List[SeldonComponent]] = None):
        """A text prompt's ids, tokenized once before the probes fan out
        (replicas share the tokenizer by construction); any other prompt as
        it is."""
        if not isinstance(prompt, str):
            return prompt
        for r in (reps if reps is not None else self.members()):
            tok = getattr(r, "_tokenizer", None)
            if tok is not None:
                return tok.encode(prompt)
        return prompt

    def loads(self) -> List[Tuple[float, float]]:
        return [replica_load(r) for r in self.members()]

    def prefix_match_len(self, prompt: Any) -> int:
        """The longest cached prefix any replica holds (a fleet nests, or a
        router reads its coverage, as one number)."""
        reps = self.members()
        prompt = self._encode_once(prompt, reps)
        return max((m for m, _ in self._probe(prompt, reps)), default=0)

    # -- the batcher-service surface the transports call -----------------
    @property
    def batcher(self):
        """Transports call ``svc.batcher.accommodates``: the fleet answers."""
        return self

    def accommodates(self, prompt: Any, max_new_tokens: Optional[int] = None) -> bool:
        """One dispatchable replica's answer (replicas are identical)."""
        from seldon_core_tpu_torch.runtime.batcher import ensure_stream_service

        for r in self._dispatchable():
            if hasattr(r, "generate"):
                return ensure_stream_service(r).batcher.accommodates(prompt, max_new_tokens)
        return False

    def submit(self, prompt: Any, max_new_tokens: Optional[int] = None,
               seed: Optional[int] = None, info: Optional[dict] = None,
               on_token: Optional[Any] = None, **identity: Any) -> Future:
        """``BatcherService.submit`` on the replica ``pick_for`` chooses, with
        the prompt tokenized once: the Future of the final token list, and
        ``on_token`` fed from that replica's batcher."""
        from seldon_core_tpu_torch.runtime.batcher import ensure_stream_service

        ids = self._encode_once(prompt)
        return ensure_stream_service(self.pick_for(ids)).submit(
            ids, max_new_tokens, seed=seed, info=info, on_token=on_token, **identity)

    # the JAX package's name for a submit from a thread that pumps
    # ``on_token``; the port's submit does not block, so it is the same call
    submit_stream = submit

    def submit_sync(self, prompt: Any, max_new_tokens: Optional[int] = None,
                    timeout_s: float = 600.0, seed: Optional[int] = None,
                    info: Optional[dict] = None, **identity: Any) -> List[int]:
        return self.submit(prompt, max_new_tokens, seed=seed, info=info,
                           **identity).result(timeout_s)

    # -- the component surface, delegated to the chosen replica ----------
    def predict(self, X, names, meta=None):
        return self.pick().predict(X, names, meta)

    def generate(self, prompts=None, *a, **kw):
        """Routed on the first prompt's cached prefix (a one-prompt request
        is the chat shape prefix routing is for)."""
        if prompts is not None and len(prompts) > 0:
            return self.pick_for(prompts[0]).generate(prompts, *a, **kw)
        return self.pick().generate(prompts, *a, **kw)

    def tags(self) -> Dict[str, Any]:
        from seldon_core_tpu_torch.components.component import client_custom_tags

        reps = self.members()
        out: Dict[str, Any] = {"replicas": len(reps)}
        for i, r in enumerate(reps):
            for k, v in client_custom_tags(r).items():
                out[f"replica_{i}_{k}"] = v
        return out

    def llm_stats(self) -> Dict[str, Any]:
        """The replicas' stats merged for the scrape: numbers sum (each
        replica's counters and gauges), fractions average, drained lists
        concatenate (each replica's deques drain once, as solo), other
        values come from the first replica."""
        stats_list = [r.llm_stats() for r in self.members() if hasattr(r, "llm_stats")]
        if not stats_list:
            return {}
        fractions = ("kv_occupancy", "kv_page_fragmentation", "spec_accept_rate",
                     "spec_tokens_per_forward", "spec_draft_overhead_fraction")
        merged = dict(stats_list[0])
        for stats in stats_list[1:]:
            for k, v in stats.items():
                cur = merged.get(k)
                if isinstance(v, list) and isinstance(cur, list):
                    merged[k] = cur + v
                elif (isinstance(v, (int, float)) and isinstance(cur, (int, float))
                      and not isinstance(v, bool)):
                    merged[k] = cur + v
        for k in fractions:  # a sum of fractions would pass 1
            if isinstance(merged.get(k), (int, float)):
                merged[k] = merged[k] / len(stats_list)
        return merged


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
                # N replicas behind one dispatcher; cached, so a rebuild and
                # the scrape walking _components see one ReplicaSet
                comp = ReplicaSet(list(comp))
                self._components[unit.name] = comp
        elif unit.implementation is not None and \
                unit.implementation != UnitImplementation.UNKNOWN_IMPLEMENTATION:
            comp = self._make_implementation(unit)
        elif unit.endpoint is not None and unit.endpoint.service_host:
            from seldon_core_tpu_torch.runtime.remote import RemoteComponent

            comp = RemoteComponent(unit.endpoint, annotations=self._annotations or None)
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


__all__ = ["GraphEngine", "PredictorState", "ReplicaSet", "UnitState", "make_puid",
           "replica_load"]
