"""Signal-driven autoscaler of the port, copied from
``seldon_core_tpu/controlplane/autoscaler.py``: the loop around the port's
``ReplicaSet`` (``runtime/engine.py``)

    poll scaling_snapshot per replica -> pure decision -> actuate

with two actuators:

- **ReplicaSet size.**  Scale-up first cancels the newest drain (a warm
  replica), else builds a replica through the injected factory and adds it
  behind prefix-aware, least-loaded dispatch.  Scale-down DRAINS
  (``ReplicaSet.drain_replica``): the replica leaves dispatch at once,
  finishes its queued and in-flight requests, and is detached
  (``ReplicaSet.collect_drained``) only on its second idle sighting, so a
  scale decision never drops a live request.  A replica the fleet's health
  check ejected is replaced on the next tick, with no stability window.
- **The prefill worker count** of a ``disaggregation="remote_prefill"``
  batcher (``ContinuousBatcher.rebalance_disagg``): when the handoff
  backlog per prefill worker stays high, one worker more; when prefill
  stays idle, one fewer.  On one card the workers share the server's
  device, so the move changes the worker count, not a device split.

The decisions are pure functions of (signals, config, history), equal to
the JAX package's (action, target and reason string;
``tests/test_torch_autoscaler.py``); ``decide_rebalance`` is the JAX
package's unchanged, including its ``decode_devices >
min_decode_devices`` guard on the upward move.  The snapshot counts the
batcher's decode slice: a one-card batcher with ``decode_devices=1``
reports 1, so with the default ``min_decode_devices`` = 1 the upward move
never fires there; ``decode_devices=2`` (the card named twice, decoding on
it) reports 2 and lets it, as does ``min_decode_devices=0``.

``tick()`` checks the fleet's health first (a replica dead since the last
tick reads as ejected in this tick's signals), decides under ``_lock``,
actuates outside it (the fleet and the batcher take their own locks), and
tallies only the actions that were applied.  The clock is injectable
(``testing.faults.FaultClock``); ``run_forever`` takes an injectable
``sleep`` too, so no decision waits on wall time.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, replace
from typing import Any, Callable, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

# Decision kinds (Decision.action)
HOLD = "hold"
SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"
REBALANCE = "rebalance"


@dataclass(frozen=True)
class ReplicaSignals:
    """One replica's scaling signals, parsed from the
    ``observability.timeline.scaling_snapshot`` dict.  The field list here
    IS the controller's consumption contract with the snapshot schema (the
    port's snapshot has the JAX package's keys)."""

    queue_depth: int = 0
    active_slots: int = 0
    total_slots: int = 1
    steps_in_flight: int = 0
    page_pressure: float = 0.0
    page_sheds_total: int = 0
    handoff_queue_depth: int = 0
    draining: bool = False
    ejected: bool = False
    prefill_devices: int = 0
    decode_devices: int = 0
    ttft_p95_s: Optional[float] = None
    queue_wait_p95_s: Optional[float] = None
    worst_gap_p95_s: Optional[float] = None

    @classmethod
    def from_scaling(cls, snap: dict) -> "ReplicaSignals":
        """Parse one ``scaling_snapshot()`` dict.  Quantiles come from the
        flight recorder's ``requests`` block when tracing is on; absent
        (tracing off) they stay None and the latency terms of the decision
        simply do not fire — load signals alone still scale."""
        req = snap.get("requests") or {}

        def q(key: str) -> Optional[float]:
            block = req.get(key) or {}
            v = block.get("p95")
            return None if v is None else float(v)

        return cls(
            queue_depth=int(snap.get("queue_depth", 0)),
            active_slots=int(snap.get("active_slots", 0)),
            total_slots=max(int(snap.get("total_slots", 1)), 1),
            steps_in_flight=int(snap.get("steps_in_flight", 0)),
            page_pressure=float(snap.get("page_pressure", 0.0)),
            page_sheds_total=int(snap.get("page_sheds_total", 0)),
            handoff_queue_depth=int(snap.get("handoff_queue_depth", 0)),
            draining=bool(snap.get("draining", False)),
            ejected=bool(snap.get("ejected", False)),
            prefill_devices=int(snap.get("prefill_devices", 0)),
            decode_devices=int(snap.get("decode_devices", 0)),
            ttft_p95_s=q("ttft_s"),
            queue_wait_p95_s=q("queue_wait_s"),
            worst_gap_p95_s=q("worst_gap_s"),
        )


@dataclass(frozen=True)
class AutoscalerConfig:
    """Thresholds and hysteresis for the scale decision.  Up and down use
    SEPARATE thresholds plus consecutive-tick stability windows and a
    cooldown, so a signal hovering at one boundary cannot flap the fleet
    (the JAX package's docs/control-plane.md, "The decision function")."""

    min_replicas: int = 1
    max_replicas: int = 4
    # scale-up triggers (any one, sustained up_stable_ticks):
    up_queue_per_slot: float = 1.0      # queued work / total slots
    up_page_pressure: float = 0.85      # page-pool in-use fraction
    up_ttft_p95_s: Optional[float] = None   # TTFT SLO (None = load-only)
    up_queue_wait_p95_s: Optional[float] = None
    up_stable_ticks: int = 2
    # scale-down trigger (all of, sustained down_stable_ticks):
    down_queue_per_slot: float = 0.25
    down_page_pressure: float = 0.5
    down_stable_ticks: int = 4
    cooldown_s: float = 30.0            # between any two scale actions
    # disagg prefill:decode rebalance (None disables):
    rebalance: bool = False
    rebalance_backlog_high: float = 1.0   # handoff backlog per prefill dev
    rebalance_backlog_low: float = 0.0    # backlog at/below = prefill slack
    rebalance_stable_ticks: int = 2
    rebalance_cooldown_s: float = 30.0
    min_prefill_devices: int = 1
    min_decode_devices: int = 1


@dataclass(frozen=True)
class Decision:
    """One tick's verdict: what to do and why.  ``action`` is one of
    hold / scale_up / scale_down / rebalance; ``target`` is the replica
    count (scale) or prefill-device count (rebalance) AFTER the action."""

    action: str = HOLD
    target: int = 0
    reason: str = ""


@dataclass(frozen=True)
class ControllerState:
    """The decision history a tick consumes — immutable so the decision
    functions stay pure (a new state is returned, never mutated in
    place).  ``over_ticks`` / ``under_ticks`` / ``long_ticks`` /
    ``short_ticks`` are the consecutive-tick stability counters;
    ``last_scale_t`` / ``last_rebalance_t`` anchor the cooldowns on the
    injected clock."""

    over_ticks: int = 0
    under_ticks: int = 0
    long_ticks: int = 0
    short_ticks: int = 0
    last_scale_t: float = float("-inf")
    last_rebalance_t: float = float("-inf")


def _fleet_pressure(signals: Sequence[ReplicaSignals]) -> Tuple[float, float]:
    """(queued work per slot, max page pressure) over the NON-draining,
    NON-ejected replicas — a draining replica's emptying queue must not
    drag the fleet mean down and mask real overload on the survivors,
    and an ejected corpse's frozen snapshot must not count as serving
    capacity at all."""
    live = [s for s in signals
            if not s.draining and not s.ejected] or list(signals)
    queued = sum(s.queue_depth + s.active_slots for s in live)
    slots = sum(s.total_slots for s in live) or 1
    pages = max((s.page_pressure for s in live), default=0.0)
    return queued / slots, pages


def decide_scale(
    signals: Sequence[ReplicaSignals],
    cfg: AutoscalerConfig,
    state: ControllerState,
    now: float,
    n_replicas: int,
    n_draining: int = 0,
    n_ejected: int = 0,
) -> Tuple[Decision, ControllerState]:
    """The pure replica-count decision: (signals, config, history) ->
    (decision, next history).  No clock reads, no I/O — ``now`` comes
    from the caller's injected clock, so a scripted scenario replays it
    deterministically."""
    if not signals:
        return Decision(HOLD, n_replicas, "no signals"), state
    queue_per_slot, page_pressure = _fleet_pressure(signals)
    live = [s for s in signals if not s.draining] or list(signals)

    over = queue_per_slot >= cfg.up_queue_per_slot or \
        page_pressure >= cfg.up_page_pressure
    if not over and cfg.up_ttft_p95_s is not None:
        over = any(s.ttft_p95_s is not None
                   and s.ttft_p95_s >= cfg.up_ttft_p95_s for s in live)
    if not over and cfg.up_queue_wait_p95_s is not None:
        over = any(s.queue_wait_p95_s is not None
                   and s.queue_wait_p95_s >= cfg.up_queue_wait_p95_s
                   for s in live)
    under = (queue_per_slot <= cfg.down_queue_per_slot
             and page_pressure <= cfg.down_page_pressure)

    state = replace(
        state,
        over_ticks=state.over_ticks + 1 if over else 0,
        under_ticks=state.under_ticks + 1 if under else 0,
    )
    in_cooldown = now - state.last_scale_t < cfg.cooldown_s
    # replicas taking fleet traffic: drained AND ejected members are out
    serving = n_replicas - n_draining - n_ejected

    # replace-on-ejection: an unplanned death is a
    # capacity loss the load signals may take ticks to notice — replace
    # the corpse NOW rather than waiting for queues to back up. Stability
    # windows don't apply (the ejection itself is the sustained signal);
    # the cooldown still does, so a flapping replica cannot stampede the
    # fleet.
    if (n_ejected > 0 and not in_cooldown
            and serving < cfg.max_replicas):
        return (
            Decision(SCALE_UP, serving + 1,
                     f"{n_ejected} replica(s) ejected — replacing"),
            replace(state, over_ticks=0, under_ticks=0, last_scale_t=now),
        )
    if (over and state.over_ticks >= cfg.up_stable_ticks
            and not in_cooldown and serving < cfg.max_replicas):
        return (
            Decision(SCALE_UP, serving + 1,
                     f"queue/slot {queue_per_slot:.2f}, pages "
                     f"{page_pressure:.2f} over for {state.over_ticks} ticks"),
            replace(state, over_ticks=0, under_ticks=0, last_scale_t=now),
        )
    if (under and state.under_ticks >= cfg.down_stable_ticks
            and not in_cooldown and serving > cfg.min_replicas):
        return (
            Decision(SCALE_DOWN, serving - 1,
                     f"queue/slot {queue_per_slot:.2f} under for "
                     f"{state.under_ticks} ticks"),
            replace(state, over_ticks=0, under_ticks=0, last_scale_t=now),
        )
    return Decision(HOLD, serving, "within band"), state


def decide_rebalance(
    signals: Sequence[ReplicaSignals],
    cfg: AutoscalerConfig,
    state: ControllerState,
    now: float,
) -> Tuple[Decision, ControllerState]:
    """The pure prefill:decode split decision for disaggregated replicas.
    The steering signal is the handoff backlog per prefill device — the
    direct trace of the prompt-length mix: long prompts pile admissions
    up on the prefill slice while decode pages stay slack; short prompts
    leave prefill idle while the decode batch is the constraint."""
    dis = [s for s in signals
           if s.prefill_devices > 0 and s.decode_devices > 0]
    if not cfg.rebalance or not dis:
        return Decision(HOLD, 0, "rebalance off or no disagg replica"), state
    s = dis[0]  # one disagg topology per predictor by construction
    backlog_per_dev = s.handoff_queue_depth / max(s.prefill_devices, 1)
    long_mix = backlog_per_dev >= cfg.rebalance_backlog_high
    short_mix = (s.handoff_queue_depth <= cfg.rebalance_backlog_low
                 and s.queue_depth == 0)
    state = replace(
        state,
        long_ticks=state.long_ticks + 1 if long_mix else 0,
        short_ticks=state.short_ticks + 1 if short_mix else 0,
    )
    if now - state.last_rebalance_t < cfg.rebalance_cooldown_s:
        return Decision(HOLD, s.prefill_devices, "rebalance cooldown"), state
    if (long_mix and state.long_ticks >= cfg.rebalance_stable_ticks
            and s.decode_devices > cfg.min_decode_devices):
        return (
            Decision(REBALANCE, s.prefill_devices + 1,
                     f"handoff backlog {s.handoff_queue_depth} over "
                     f"{s.prefill_devices} prefill devs for "
                     f"{state.long_ticks} ticks"),
            replace(state, long_ticks=0, short_ticks=0,
                    last_rebalance_t=now),
        )
    if (short_mix and state.short_ticks >= cfg.rebalance_stable_ticks
            and s.prefill_devices > cfg.min_prefill_devices):
        return (
            Decision(REBALANCE, s.prefill_devices - 1,
                     f"prefill idle for {state.short_ticks} ticks"),
            replace(state, long_ticks=0, short_ticks=0,
                    last_rebalance_t=now),
        )
    return Decision(HOLD, s.prefill_devices, "split within band"), state


class Autoscaler:
    """The control loop around a :class:`~seldon_core_tpu_torch.runtime.engine.
    ReplicaSet`: gather per-replica signals, run the pure decisions, apply
    them.  ``tick()`` is one pass — tests and the fault harness drive it
    directly; ``run_forever`` is the production loop on the injectable
    clock/sleep pair (the operator's idiom, controlplane/operator.py).

    Concurrency: ``tick()`` runs on the controller thread while
    ``autoscaler_stats()`` serves the /metrics scrape thread and a second
    tick may arrive from an admin trigger — all mutable state
    (ControllerState, tallies, last decision) lives under ``self._lock``.
    The actuators are NOT called under it: ``ReplicaSet`` and the batcher
    take their own locks, and nesting ours outside theirs would couple
    two lock orders for no benefit (the tick section below swaps state
    first, then actuates lock-free).
    """

    def __init__(
        self,
        replica_set: Any,
        config: Optional[AutoscalerConfig] = None,
        replica_factory: Optional[Callable[[], Any]] = None,
        clock: Callable[[], float] = time.monotonic,
        interval_s: float = 5.0,
        snapshot_fn: Optional[Callable[[Any], dict]] = None,
    ):
        self.replica_set = replica_set
        self.config = config or AutoscalerConfig()
        self.replica_factory = replica_factory
        self.clock = clock
        self.interval_s = float(interval_s)
        if snapshot_fn is None:
            from seldon_core_tpu_torch.observability.timeline import scaling_snapshot

            snapshot_fn = scaling_snapshot
        self._snapshot_fn = snapshot_fn
        self._lock = threading.Lock()
        self._state = ControllerState()
        self._stop = threading.Event()
        # lifetime tallies for /metrics (sync_controlplane catch-up idiom)
        self._scale_ups_total = 0
        self._scale_downs_total = 0
        self._rebalances_total = 0
        self._collected_total = 0
        self._ticks_total = 0
        self._last_decision = Decision()

    # -- signal gathering ------------------------------------------------
    def signals(self) -> List[ReplicaSignals]:
        reps = self.replica_set.members()
        draining = self.replica_set.draining_members()
        ej = getattr(self.replica_set, "ejected_members", None)
        ejected = ej() if ej is not None else []
        out = []
        for r in reps:
            snap = dict(self._snapshot_fn(r))
            if r in draining:
                snap["draining"] = True
            if r in ejected:
                snap["ejected"] = True
            out.append(ReplicaSignals.from_scaling(snap))
        return out

    # -- one pass ---------------------------------------------------------
    def tick(self) -> Decision:
        """One control pass: decide on fresh signals, actuate, and sweep
        drained replicas.  Returns the scale decision (rebalance runs as a
        side decision when enabled)."""
        # sweep fleet health FIRST: a replica that died since the last
        # tick must read as ejected in THIS tick's signals, so the replace
        # branch fires one control pass after the death, not two
        check = getattr(self.replica_set, "check_health", None)
        if check is not None:
            check()
        sigs = self.signals()
        now = self.clock()
        n = len(self.replica_set.members())
        n_drain = len(self.replica_set.draining_members())
        ej = getattr(self.replica_set, "ejected_members", None)
        n_ej = len(ej()) if ej is not None else 0
        with self._lock:
            self._ticks_total += 1
            decision, self._state = decide_scale(
                sigs, self.config, self._state, now, n, n_drain, n_ej)
            reb = Decision(HOLD, 0, "")
            if self.config.rebalance:
                reb, self._state = decide_rebalance(
                    sigs, self.config, self._state, now)
            self._last_decision = decision
        # actuate OUTSIDE the controller lock (see class docstring);
        # tallies count actions APPLIED, not decisions — an unactuatable
        # decision (no factory, last replica, rebalance refused) must not
        # tick the /metrics event counters while the fleet never moves
        applied_up = applied_down = applied_reb = False
        if decision.action == SCALE_UP:
            applied_up = self._actuate_up(decision)
        elif decision.action == SCALE_DOWN:
            applied_down = self._actuate_down(decision)
        if reb.action == REBALANCE:
            applied_reb = self._actuate_rebalance(reb)
        collected = self.replica_set.collect_drained()
        with self._lock:
            if applied_up:
                self._scale_ups_total += 1
            if applied_down:
                self._scale_downs_total += 1
            if applied_reb:
                self._rebalances_total += 1
            if collected:
                self._collected_total += len(collected)
        if collected:
            logger.info("autoscaler detached %d drained replica(s)",
                        len(collected))
        return decision

    def _actuate_up(self, decision: Decision) -> bool:
        # a replica still draining is WARM (loaded params, hot caches):
        # cancelling its drain is strictly cheaper than a cold build
        resumed = self.replica_set.undrain_replica()
        if resumed is not None:
            logger.info("autoscaler resumed a draining replica toward %d: "
                        "%s", decision.target, decision.reason)
            return True
        if self.replica_factory is None:
            logger.warning("scale-up decided (%s) but no replica factory "
                           "configured", decision.reason)
            return False
        replica = self.replica_factory()
        self.replica_set.add_replica(replica)
        logger.info("autoscaler scale-up to %d: %s", decision.target,
                    decision.reason)
        return True

    def _actuate_down(self, decision: Decision) -> bool:
        drained = self.replica_set.drain_replica()
        if drained is not None:
            logger.info("autoscaler draining one replica toward %d: %s",
                        decision.target, decision.reason)
        return drained is not None

    def _actuate_rebalance(self, decision: Decision) -> bool:
        from seldon_core_tpu_torch.runtime.batcher import get_batcher_service

        moved = False
        for r in self.replica_set.members():
            svc = get_batcher_service(r)
            b = getattr(svc, "batcher", None)
            if b is not None and getattr(b, "_remote", None) is not None:
                if b.rebalance_disagg(decision.target):
                    moved = True
                    logger.info("autoscaler rebalanced prefill slice to "
                                "%d devices: %s", decision.target,
                                decision.reason)
        return moved

    # -- loop / stats ------------------------------------------------------
    def run_forever(self, sleep: Optional[Callable[[float], Any]] = None
                    ) -> None:
        """The production loop.  ``sleep`` is injectable like the clock —
        tests pass ``clock.advance`` so the loop runs in zero wall time;
        the default real sleep waits on the stop event so ``stop()``
        interrupts it immediately."""
        if sleep is None:
            sleep = lambda s: self._stop.wait(s)  # noqa: E731
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                # one broken pass (a replica torn down mid-poll) must not
                # kill the controller; the next tick re-reads the world
                logger.exception("autoscaler tick failed")
            sleep(self.interval_s)

    def stop(self) -> None:
        self._stop.set()

    def autoscaler_stats(self) -> dict:
        """Lifetime tallies + the current shape, for
        ``MetricsRegistry.sync_controlplane`` (scrape-thread reader — the
        same lock the tick's writes hold)."""
        with self._lock:
            last = self._last_decision
            out = {
                "autoscaler_replicas": len(self.replica_set.members()),
                "autoscaler_draining": len(
                    self.replica_set.draining_members()),
                "autoscaler_ticks_total": self._ticks_total,
                "autoscaler_scale_ups_total": self._scale_ups_total,
                "autoscaler_scale_downs_total": self._scale_downs_total,
                "autoscaler_rebalances_total": self._rebalances_total,
                "autoscaler_collected_total": self._collected_total,
                "autoscaler_last_action": last.action,
            }
        return out
