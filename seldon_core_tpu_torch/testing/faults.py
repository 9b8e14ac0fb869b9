"""Deterministic fault injection for the port's resilience tests: a copy of
``seldon_core_tpu/testing/faults.py`` over the port's components, batchers
and replica fleet.

Everything is seeded or scheduled: no wall-clock randomness and no sleeps.
Latency is injected by advancing a :class:`FaultClock` (the clock object
given to a Deadline, a CircuitBreaker or a ReplicaSet), so a test burns a
budget or a breaker's reset window in no wall time::

    clock = FaultClock()
    comp = FaultyComponent(FaultSchedule.flaps("EEEEEO"), clock=clock)
    engine = GraphEngine(spec, components={"m": comp}, device="cpu",
                         resilience=ResilienceConfig(breaker_failures=5,
                                                     breaker_reset_s=1.0, clock=clock))

A schedule is per call: call i takes ``schedule[i]``, and the last entry
repeats, so a finite schedule describes an infinite behaviour.

The fleet's faults: ``BatcherKiller`` kills a batcher's loop from its
``_chaos`` hook (where a device fault would kill it), ``HandoffPoisoner``
spoils finished remote prefills, ``DispatchFailer`` fails a replica's
dispatches, and ``LeakSweep`` injects a one-shot fault at each acquire
boundary of a live batcher and checks that nothing stays held.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.payload import SeldonError


class FaultClock:
    """A monotonic clock moved by hand. Pass it wherever a ``clock``
    callable is taken; calling it returns the current fake time."""

    def __init__(self, start: float = 1000.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def now(self) -> float:
        return self.t

    def advance(self, seconds: float) -> float:
        if seconds < 0:
            raise ValueError("clocks only move forward")
        self.t += seconds
        return self.t


@dataclass
class FaultSpec:
    """One call's behaviour: a latency (FaultClock seconds), then success
    or a raised error."""

    latency_s: float = 0.0
    error: Optional[BaseException] = None

    @classmethod
    def ok(cls, latency_s: float = 0.0) -> "FaultSpec":
        return cls(latency_s=latency_s)

    @classmethod
    def fail(cls, message: str = "injected fault", status_code: int = 503,
             latency_s: float = 0.0) -> "FaultSpec":
        return cls(latency_s=latency_s,
                   error=SeldonError(message, status_code=status_code, reason="INJECTED_FAULT"))


class FaultSchedule:
    """A per-call schedule of FaultSpecs; past its end the last entry
    repeats."""

    def __init__(self, specs: Sequence[FaultSpec]):
        if not specs:
            raise ValueError("schedule needs at least one entry")
        self.specs: List[FaultSpec] = list(specs)

    def __getitem__(self, i: int) -> FaultSpec:
        return self.specs[min(i, len(self.specs) - 1)]

    def __len__(self) -> int:
        return len(self.specs)

    @classmethod
    def always_ok(cls, latency_s: float = 0.0) -> "FaultSchedule":
        return cls([FaultSpec.ok(latency_s)])

    @classmethod
    def always_fail(cls, status_code: int = 503) -> "FaultSchedule":
        return cls([FaultSpec.fail(status_code=status_code)])

    @classmethod
    def flaps(cls, pattern: str, latency_s: float = 0.0,
              status_code: int = 503) -> "FaultSchedule":
        """One character a call: 'E' (or 'F') an error, 'O' (or '.', 'S')
        a success; ``"EEEEEO"`` fails five calls, then succeeds forever."""
        specs = []
        for ch in pattern:
            if ch in ("E", "e", "F", "f"):
                specs.append(FaultSpec.fail(status_code=status_code, latency_s=latency_s))
            elif ch in ("O", "o", ".", "S", "s"):
                specs.append(FaultSpec.ok(latency_s))
            else:
                raise ValueError(f"unknown flap char {ch!r} (use E/O)")
        return cls(specs)

    @classmethod
    def seeded(cls, seed: int, n: int, error_rate: float = 0.0, latency_s: float = 0.0,
               latency_jitter_s: float = 0.0, status_code: int = 503) -> "FaultSchedule":
        """n entries drawn from ``random.Random(seed)``: the same seed gives
        the same schedule."""
        rng = random.Random(seed)
        specs = []
        for _ in range(n):
            lat = latency_s + (rng.random() * latency_jitter_s if latency_jitter_s else 0.0)
            if rng.random() < error_rate:
                specs.append(FaultSpec.fail(status_code=status_code, latency_s=lat))
            else:
                specs.append(FaultSpec.ok(lat))
        return cls(specs)


class FaultyComponent(SeldonComponent):
    """A graph node with scripted behaviour. Each call advances the
    FaultClock by its scheduled latency, then raises its scheduled error or
    delegates to ``inner`` (default: echo). ``is_async=True`` (the default)
    makes the engine treat it as an asynchronous node, the kind it wraps in
    a breaker. ``calls`` counts the calls, so a test shows a node that was
    short-circuited never ran."""

    def __init__(self, schedule: Optional[FaultSchedule] = None,
                 clock: Optional[FaultClock] = None, inner: Optional[SeldonComponent] = None,
                 is_async: bool = True, name: str = "faulty"):
        super().__init__()
        self.schedule = schedule or FaultSchedule.always_ok()
        self.clock = clock
        self.inner = inner
        self.is_async = is_async
        self.name = name
        self.calls = 0
        self.on_call: Optional[Callable[[int, FaultSpec], None]] = None

    def _apply(self) -> None:
        spec = self.schedule[self.calls]
        self.calls += 1
        if self.on_call is not None:
            self.on_call(self.calls - 1, spec)
        if spec.latency_s and self.clock is not None:
            self.clock.advance(spec.latency_s)
        if spec.error is not None:
            raise spec.error

    def _delegate(self, method: str, X, names, meta=None):
        self._apply()
        if self.inner is not None:
            fn = getattr(self.inner, method, None)
            if fn is not None:
                return fn(X, names, meta=meta)
        return X

    async def predict(self, X, names, meta=None):
        return self._delegate("predict", X, names, meta)

    async def transform_input(self, X, names, meta=None):
        return self._delegate("transform_input", X, names, meta)

    async def transform_output(self, X, names, meta=None):
        return self._delegate("transform_output", X, names, meta)

    async def route(self, X, names):
        self._apply()
        if self.inner is not None and hasattr(self.inner, "route"):
            return self.inner.route(X, names)
        return 0

    async def aggregate(self, Xs, names):
        self._apply()
        if self.inner is not None and hasattr(self.inner, "aggregate"):
            return self.inner.aggregate(Xs, names)
        return np.mean([np.asarray(x) for x in Xs], axis=0)


def inject_faults(component: SeldonComponent, schedule: FaultSchedule,
                  clock: Optional[FaultClock] = None) -> FaultyComponent:
    """Wrap a component in a fault schedule (its methods run only on the
    calls the schedule lets through)."""
    return FaultyComponent(schedule=schedule, clock=clock, inner=component)


# ---------------------------------------------------------------------------
# Fleet chaos: a batcher's loop calls its ``_chaos`` hook at the top of every
# turn with itself as the argument; a hook that raises dies where a device
# fault would, and the crash path fails every request of that loop. Triggers
# are explicit (an event the test sets, or a predicate over the batcher), so
# a kill lands mid-decode by construction, not by timing.
# ---------------------------------------------------------------------------


class BatcherKiller:
    """A one-shot killer of batcher loops, installed as ``batcher._chaos``
    on any number of batchers. It fires on the first loop turn where
    ``trigger`` is truthy (a ``threading.Event``, a zero-argument callable,
    or a predicate taking the batcher). With ``busiest=True`` only the
    batcher holding the most active slots at that moment dies ("kill the
    busiest replica mid-decode" without guessing where the router sent the
    traffic). After the kill it disarms everywhere, so the fleet's half-open
    probe, which restarts the same loop, finds a healthy batcher.
    ``killed_thread`` is the loop thread it killed: a test joins it to see
    the crash path's end (the thread clears ``batcher._thread`` last)."""

    def __init__(self, trigger: Optional[Any] = None, busiest: bool = False,
                 message: str = "chaos: batcher loop killed"):
        self.trigger = trigger
        self.busiest = busiest
        self.message = message
        self._armed = True
        self._lock = threading.Lock()
        self._installed: List[Any] = []
        self.kills = 0
        self.killed: Optional[Any] = None  # the batcher that died
        self.killed_thread: Optional[threading.Thread] = None

    def install(self, *batchers: Any) -> "BatcherKiller":
        """Attach to each batcher's ``_chaos`` hook; returns self."""
        for b in batchers:
            b._chaos = self
            self._installed.append(b)
        return self

    def _triggered(self, batcher: Any) -> bool:
        t = self.trigger
        if t is None:
            return True
        if hasattr(t, "is_set"):
            return bool(t.is_set())
        try:
            return bool(t(batcher))
        except TypeError:
            return bool(t())

    @staticmethod
    def _active_slots(batcher: Any) -> int:
        return sum(1 for s in batcher._slots if s.active)

    def __call__(self, batcher: Any) -> None:
        # every batcher's loop runs on its own thread: the disarm is a
        # check-then-set between victims, under a lock
        with self._lock:
            if not self._armed or not self._triggered(batcher):
                return
            if self.busiest:
                mine = self._active_slots(batcher)
                peak = max((self._active_slots(b) for b in self._installed), default=0)
                if mine == 0 or mine < peak:
                    return  # a busier sibling takes it
            self._armed = False
            self.kills += 1
            self.killed = batcher
            self.killed_thread = threading.current_thread()
        raise SeldonError(self.message, status_code=503, reason="INJECTED_FAULT")


class HandoffPoisoner:
    """Spoils the first ``first_n`` finished remote prefills of a
    disaggregated batcher so the decode side's import raises (the
    "poisoned handoff" fault): each worker's ``_prefill_one`` runs and
    publishes as usual, but the handoff arrives with ``staged`` replaced by
    an unimportable payload. With the network transport the poison moves
    to the wire: the frame's last tensor buffer loses 16 bytes, so the
    receiver's frame decode fails its bounds check (the metadata, and so
    the job id, still parse) and resolves the job with an error handoff.
    Later handoffs pass untouched."""

    def __init__(self, batcher: Any, first_n: int = 1, poison: Any = "poisoned-kv-payload"):
        self.first_n = int(first_n)
        self.poison = poison
        self.poisoned = 0
        self._lock = threading.Lock()
        if getattr(batcher, "_remote", None) is None:
            raise ValueError("HandoffPoisoner needs a disaggregated batcher")
        for worker in batcher._remote.workers:
            if getattr(worker, "transport", "device") == "network":
                real_frame = worker._frame_handoff

                def poisoned_frame(h, _real=real_frame):
                    buffers = list(_real(h))
                    if self._shot():
                        buffers[-1] = memoryview(buffers[-1]).cast("B")[:-16]
                    return buffers

                worker._frame_handoff = poisoned_frame
                continue
            real = worker._prefill_one

            def poisoned_prefill(req, _real=real):
                h = _real(req)
                if self._shot():
                    h.staged = self.poison
                return h

            worker._prefill_one = poisoned_prefill

    def _shot(self) -> bool:
        with self._lock:
            if self.poisoned < self.first_n:
                self.poisoned += 1
                return True
            return False


class LeakSweep:
    """Error-path leak harness: a one-shot fault at each acquire boundary
    of a live batcher, and a probe of every reference the unwind paths
    own. For each boundary the test drives one request through the fault
    (it fails, contained, and the batch serves on), then ``assert_clean``
    checks that every such count is back to zero: pages held by slots,
    raised trie pins, adapter pins, staged remote jobs, undelivered
    handoffs, resume-journal entries.

    ========================  ============================================
    boundary                  injected fault (one shot)
    ========================  ============================================
    ``adapter-pin``           ``AdapterRegistry.resolve_and_pin`` raises
                              KeyError at submit: the 400 path holds no pin.
    ``page-alloc``            ``_alloc_pages`` returns None while armed:
                              admission exhaustion, whose unwind drops the
                              prefix pins ``match_and_pin`` took.
    ``radix-cow``             only the first ``_alloc_pages`` fails: the
                              CoW pin is dropped, the retry succeeds, and
                              the pin is freed exactly once.
    ``prefill-stage``         ``PrefillWorker._prefill_one`` raises: the
                              worker publishes an error handoff and the
                              decode side releases the staged slot's pages.
    ``handoff-import``        the staged KV is replaced by an unimportable
                              payload: ``_consume_handoffs`` releases the
                              slot, its pages and its prefix pins.
    ``journal-record``        ``ResumeJournal.record`` raises: the fleet
                              submit fails before any entry exists.
    ========================  ============================================

    ``boundaries()`` lists those the batcher's configuration has (adapters?
    a trie? prefill workers? a fleet?), so one parametrised test sweeps
    every configuration without dead arms. The port's batcher is paged, so
    ``page-alloc`` applies to every batcher with a page pool."""

    POISON = "leaksweep-poisoned-kv"

    def __init__(self, batcher: Any, engine: Any = None):
        self.batcher = batcher
        self.engine = engine
        self.fired = 0
        self._lock = threading.Lock()
        self._shots = 0
        self._restore: List[Any] = []  # (obj, attr, original)

    def boundaries(self) -> List[str]:
        b, out = self.batcher, []
        if getattr(b, "_adapters", None) is not None:
            out.append("adapter-pin")
        if getattr(b, "_allocator", None) is not None:
            out.append("page-alloc")
            if getattr(b, "_radix", None) is not None:
                out.append("radix-cow")
        if getattr(b, "_remote", None) is not None:
            out.append("prefill-stage")
            out.append("handoff-import")
        if self.engine is not None and getattr(self.engine, "_journal", None) is not None:
            out.append("journal-record")
        return out

    def _take_shot(self) -> bool:
        with self._lock:
            if self._shots <= 0:
                return False
            self._shots -= 1
            self.fired += 1
            return True

    def _wrap(self, obj: Any, attr: str, wrapper: Callable) -> None:
        original = getattr(obj, attr)
        setattr(obj, attr, wrapper(original))
        self._restore.append((obj, attr, original))

    def disarm(self) -> None:
        """Restore every wrapped method (idempotent)."""
        while self._restore:
            obj, attr, original = self._restore.pop()
            setattr(obj, attr, original)
        with self._lock:
            self._shots = 0

    def arm(self, boundary: str, shots: int = 1) -> "LeakSweep":
        """Install the one-shot fault at ``boundary``; returns self."""
        if boundary not in self.boundaries():
            raise ValueError(f"boundary {boundary!r} not applicable here "
                             f"(have: {self.boundaries()})")
        self.disarm()
        with self._lock:
            self._shots = int(shots)
        getattr(self, "_arm_" + boundary.replace("-", "_"))()
        return self

    def _arm_adapter_pin(self) -> None:
        def wrapper(real):
            def resolve_and_pin(name):
                if name and self._take_shot():
                    raise KeyError(f"leaksweep: injected adapter fault for {name!r}")
                return real(name)
            return resolve_and_pin

        self._wrap(self.batcher._adapters, "resolve_and_pin", wrapper)

    def _arm_page_alloc(self) -> None:
        # while a shot is left EVERY allocation fails: the admission takes
        # its exhaustion unwind (shed or wait), not the trie-eviction retry
        def wrapper(real):
            def _alloc_pages(*args):
                if self._take_shot():
                    return None
                return real(*args)
            return _alloc_pages

        self._wrap(self.batcher, "_alloc_pages", wrapper)

    def _arm_radix_cow(self) -> None:
        # the same point with one shot, driven by a partial-block prefix:
        # the first (CoW-funded) allocation fails, the CoW pin is dropped
        # and the retry succeeds
        self._arm_page_alloc()

    def _arm_prefill_stage(self) -> None:
        for worker in self.batcher._remote.workers:
            def wrapper(real):
                def _prefill_one(req):
                    if self._take_shot():
                        raise SeldonError("leaksweep: injected prefill fault", status_code=503,
                                          reason="INJECTED_FAULT")
                    return real(req)
                return _prefill_one

            self._wrap(worker, "_prefill_one", wrapper)

    def _arm_handoff_import(self) -> None:
        for worker in self.batcher._remote.workers:
            def wrapper(real):
                def _prefill_one(req):
                    h = real(req)
                    if self._take_shot():
                        h.staged = self.POISON
                    return h
                return _prefill_one

            self._wrap(worker, "_prefill_one", wrapper)

    def _arm_journal_record(self) -> None:
        def wrapper(real):
            def record(entry):
                if self._take_shot():
                    raise SeldonError("leaksweep: injected journal fault", status_code=503,
                                      reason="INJECTED_FAULT")
                return real(entry)
            return record

        self._wrap(self.engine._journal, "record", wrapper)

    def residue(self) -> dict:
        """Every count the unwind paths own, as a dict that must be ALL
        ZEROS at idle. Cached trie blocks are a cache, not a leak:
        ``slot_pages`` subtracts them, and a leaked pin shows as
        ``shared_pins`` (a cached page still referenced by more than the
        trie while no slot holds it)."""
        b = self.batcher
        out = {}
        if getattr(b, "_allocator", None) is not None:
            _, in_use, _ = b._allocator.stats()
            cached = shared_pins = 0
            if b._radix is not None:
                rs = b._radix.stats()
                cached = rs["prefix_cached_blocks"]
                shared_pins = rs["prefix_shared_pages"]
            out["slot_pages"] = in_use - cached
            out["shared_pins"] = shared_pins
        if getattr(b, "_adapters", None) is not None:
            out["adapter_pins"] = sum(b._adapters.stats()["adapter_pins"].values())
        if getattr(b, "_remote", None) is not None:
            out["staged_jobs"] = len(b._remote_jobs)
            out["ready_handoffs"] = b._transfer.ready_depth()
        if self.engine is not None and getattr(self.engine, "_journal", None) is not None:
            out["journal_depth"] = self.engine._journal.depth()
        return out

    def assert_clean(self, context: str = "") -> None:
        leaks = {k: v for k, v in self.residue().items() if v != 0}
        if leaks:
            where = f" after {context}" if context else ""
            raise AssertionError(f"leak residue{where}: {leaks}")

    def sweep(self, drive: Callable[[str], None],
              boundaries: Optional[Sequence[str]] = None) -> List[str]:
        """Arm each boundary in turn, let ``drive(boundary)`` push one
        request through its fault, disarm, and assert zero residue. Returns
        the boundaries swept; one whose fault never fired raises, so a sweep
        cannot skip a layer unseen."""
        swept = []
        for boundary in (boundaries or self.boundaries()):
            before = self.fired
            self.arm(boundary)
            try:
                drive(boundary)
            finally:
                self.disarm()
            if self.fired == before:
                raise AssertionError(f"leaksweep: fault at {boundary!r} never fired — the "
                                     f"drive did not reach this boundary")
            self.assert_clean(context=boundary)
            swept.append(boundary)
        return swept


class DispatchFailer:
    """Scripted dispatch failures for a replica's BatcherService: wraps
    ``submit_sync`` so call i takes ``schedule[i]`` before delegating, the
    repeated failures that open the fleet's per-replica breaker without
    touching the batcher's loop. Latencies advance the FaultClock."""

    def __init__(self, service: Any, schedule: FaultSchedule,
                 clock: Optional[FaultClock] = None):
        self.schedule = schedule
        self.clock = clock
        self.calls = 0
        self._real = service.submit_sync
        self._lock = threading.Lock()
        service.submit_sync = self._submit_sync

    def _submit_sync(self, *args, **kwargs):
        with self._lock:
            spec = self.schedule[self.calls]
            self.calls += 1
        if spec.latency_s and self.clock is not None:
            self.clock.advance(spec.latency_s)
        if spec.error is not None:
            raise spec.error
        return self._real(*args, **kwargs)


__all__ = ["BatcherKiller", "DispatchFailer", "FaultClock", "FaultSchedule", "FaultSpec",
           "FaultyComponent", "HandoffPoisoner", "LeakSweep", "inject_faults"]
