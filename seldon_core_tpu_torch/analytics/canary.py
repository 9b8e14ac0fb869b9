"""Graph-level canary and shadow traffic of the port, copied from
``seldon_core_tpu/analytics/canary.py``:

- :class:`CanaryRouter` — a ROUTER over ``[baseline, candidate]`` that
  sends a deterministic ``fraction`` of live traffic to the candidate and
  compares the two branches' latency and error rate.  Baseline latencies
  stream into a :class:`~seldon_core_tpu_torch.analytics.outliers.
  MahalanobisOutlierDetector`'s running statistics (on the router's
  device), candidate windows are scored against them without folding, and
  "degraded" means statistically outlying against the baseline's own
  distribution.  On degradation the router ROLLS BACK: every later request
  routes to baseline and in-flight candidate requests complete, so the
  rollback never fails a client request.  Rewards arrive through the
  bandit routers' ``send_feedback`` (``analytics/routers._BanditRouter``);
  latencies through the engine's routed-branch hook ``observe_outcome``,
  timed on the engine's injectable clock.
- :class:`ShadowNode` — wraps a primary component and mirrors a
  deterministic fraction of ``predict`` and ``generate`` calls to a shadow
  whose answers are compared (max-abs-diff for arrays, exact match for
  token lists) and discarded.  Shadow failures are counted and swallowed:
  the client never sees them.

The split is a pure function of the request counter and the rollback a
pure function of the two windows, so a warmup -> canary -> rollback cycle
replays exactly under ``testing.faults.FaultClock``; its phases and
rollback reasons equal the JAX package's (``tests/test_torch_canary.py``).
Each evaluation on the card is one small inverse on the device and one
copy of the scores back to the host, under the router's lock.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from seldon_core_tpu_torch.analytics.routers import _BanditRouter
from seldon_core_tpu_torch.components.component import SeldonComponent

logger = logging.getLogger(__name__)

BASELINE = 0
CANDIDATE = 1

# rollout phases (CanaryRouter.phase)
CANARY = "canary"            # splitting traffic, evaluating
PROMOTED = "promoted"        # candidate won: it takes all traffic
ROLLED_BACK = "rolled_back"  # candidate degraded: baseline takes all

_PHASE_CODES = {CANARY: 0, PROMOTED: 1, ROLLED_BACK: 2}


def canary_split(n: int, fraction: float) -> int:
    """The deterministic traffic split: request number ``n`` (0-based)
    goes to the candidate iff it crosses the next ``fraction`` boundary —
    ``int((n+1)*f) > int(n*f)``.  Over any window the candidate share is
    within one request of ``fraction``, with no RNG: the same request
    sequence always splits the same way (the property every replayed
    rollout test rests on)."""
    if fraction <= 0.0:
        return BASELINE
    if fraction >= 1.0:
        return CANDIDATE
    return CANDIDATE if int((n + 1) * fraction) > int(n * fraction) \
        else BASELINE


def evaluate_canary(
    baseline_rows: Sequence[float],
    candidate_rows: Sequence[float],
    baseline_errors: Sequence[int],
    candidate_errors: Sequence[int],
    detector: Any,
    *,
    min_samples: int,
    outlier_fraction: float,
    max_error_rate_excess: float,
) -> Optional[str]:
    """The PURE rollback decision over two observation windows.  Returns a
    degradation reason, or None when the candidate holds.  ``detector``
    is the Mahalanobis scorer whose running statistics the baseline rows
    have already been folded into; candidate latencies are scored against
    them WITHOUT folding (``score_frozen``) — a sustained degradation
    must not shift the reference distribution toward itself — and the
    candidate is latency-degraded when more than ``outlier_fraction`` of
    its window scores past the detector's threshold.  Error-rate
    degradation is a straight excess comparison of window means."""
    # one engine observation lands in BOTH windows (latency + error), so
    # the sample floor is the larger window per branch, not the sum
    if (max(len(candidate_rows), len(candidate_errors)) < min_samples
            or max(len(baseline_rows), len(baseline_errors)) < min_samples):
        return None
    if candidate_errors or baseline_errors:
        base_err = float(np.mean(baseline_errors)) if baseline_errors else 0.0
        cand_err = float(np.mean(candidate_errors)) if candidate_errors \
            else 0.0
        if cand_err - base_err > max_error_rate_excess:
            return (f"error rate {cand_err:.2f} exceeds baseline "
                    f"{base_err:.2f} by > {max_error_rate_excess:.2f}")
    if candidate_rows:
        scores = detector.score_frozen(
            np.asarray(candidate_rows, dtype=np.float64)[:, None])
        frac = float(np.mean(scores > detector.threshold))
        if frac > outlier_fraction:
            return (f"{frac:.2f} of candidate latencies are outliers vs "
                    f"the baseline distribution (threshold "
                    f"{detector.threshold})")
    return None


class CanaryRouter(_BanditRouter):
    """ROUTER over ``[baseline, candidate]`` with automatic rollback.

    Observations arrive through two existing paths, neither new to the
    engine: the routed-branch outcome hook (``observe_outcome`` — the
    engine times every routed request's subtree on its injectable clock)
    and the feedback replay path (``send_feedback`` — shared with the
    bandit routers; rewards < 0.5 count as errors).  Every
    ``eval_every`` candidate observations the rollback decision runs
    (:func:`evaluate_canary`); a degraded candidate flips the phase to
    ``rolled_back`` and all later traffic routes to baseline.  A
    candidate that survives ``promote_after`` evaluations is PROMOTED
    (0 = stay in canary until told).

    All mutable state lives under the inherited ``_lock`` (route,
    observe, feedback and the /metrics scrape race); the Mahalanobis
    detector holds its own lock and is only ever called with ours held
    — a one-way lock order with no reverse edge."""

    def __init__(
        self,
        fraction: float = 0.1,
        window: int = 64,
        min_samples: int = 8,
        eval_every: int = 8,
        outlier_threshold: float = 3.0,
        outlier_fraction: float = 0.5,
        max_error_rate_excess: float = 0.2,
        promote_after: int = 0,
        seed: Optional[int] = None,
        device: Any = None,
        **kwargs: Any,
    ):
        super().__init__(n_branches=2, seed=seed, **kwargs)
        if not 0.0 <= float(fraction) <= 1.0:
            raise ValueError(f"fraction must be in [0,1], got {fraction}")
        from seldon_core_tpu_torch.analytics.outliers import MahalanobisOutlierDetector

        self.fraction = float(fraction)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.eval_every = max(int(eval_every), 1)
        self.outlier_fraction = float(outlier_fraction)
        self.max_error_rate_excess = float(max_error_rate_excess)
        self.promote_after = int(promote_after)
        self.phase = CANARY
        self.rollback_reason = ""
        self._routed = 0
        self._lat: List[Any] = [deque(maxlen=self.window) for _ in range(2)]
        self._err: List[Any] = [deque(maxlen=self.window) for _ in range(2)]
        # baseline rows not yet folded into the detector's running stats —
        # BOUNDED (evaluations drain it, but a terminal-phase router never
        # evaluates again, and an unbounded buffer would grow one float
        # per baseline request for the router's lifetime)
        self._baseline_unfolded: Any = deque(maxlen=max(4 * self.window, 256))
        self._since_eval = 0
        self.evaluations_total = 0
        self.rollbacks_total = 0
        self._detector = MahalanobisOutlierDetector(
            threshold=outlier_threshold, device=device)
        # readiness-time prewarm: the first score() on a card initialises
        # the device's solver (paying that inside _evaluate_locked would
        # park the engine's serving thread under the router lock); score a
        # dummy row now, then zero it back out
        self._detector.score(np.zeros((1, 1)))
        self._detector.reset_stats()

    # -- routing ---------------------------------------------------------
    def route(self, X: np.ndarray, names: Sequence[str]) -> int:
        with self._lock:
            if self.phase == ROLLED_BACK:
                branch = BASELINE
            elif self.phase == PROMOTED:
                branch = CANDIDATE
            else:
                branch = canary_split(self._routed, self.fraction)
                self._routed += 1
            self._last_branch = branch
            return branch

    # -- observations ----------------------------------------------------
    def observe_outcome(self, branch: int, latency_s: float,
                        error: bool = False) -> None:
        """The engine's routed-branch hook: one (latency, error) sample on
        the engine's injectable clock.  Also callable directly by a
        serving harness feeding per-branch TTFT quantiles."""
        if branch not in (BASELINE, CANDIDATE):
            return
        with self._lock:
            self._lat[branch].append(float(latency_s))
            self._err[branch].append(1 if error else 0)
            if branch == BASELINE and not error and self.phase == CANARY:
                # only healthy baseline latencies define "normal" — and
                # only while there is still a decision to make: a
                # promoted/rolled-back router never evaluates again, so
                # accumulating for it would be a pure leak
                self._baseline_unfolded.append(float(latency_s))
            if branch == CANDIDATE and self.phase == CANARY:
                self._since_eval += 1
                if self._since_eval >= self.eval_every:
                    self._since_eval = 0
                    self._evaluate_locked()

    def send_feedback(self, features, feature_names, reward, truth,
                      routing: Optional[int] = None) -> None:
        """The bandit routers' reward path plus the canary's error signal:
        reward < 0.5 counts as a candidate/baseline error sample."""
        super().send_feedback(features, feature_names, reward, truth,
                              routing=routing)
        if routing is None or int(routing) not in (BASELINE, CANDIDATE):
            return
        branch = int(routing)
        with self._lock:
            self._err[branch].append(1 if float(reward) < 0.5 else 0)
            if branch == CANDIDATE and self.phase == CANARY:
                self._since_eval += 1
                if self._since_eval >= self.eval_every:
                    self._since_eval = 0
                    self._evaluate_locked()

    # -- the decision ----------------------------------------------------
    def _evaluate_locked(self) -> None:
        """Run one rollback evaluation (callers hold ``self._lock``)."""
        if self._baseline_unfolded:
            # fold pending baseline rows into the detector's running
            # statistics (scores discarded — this call is the fold)
            self._detector.score(
                np.asarray(list(self._baseline_unfolded),
                           dtype=np.float64)[:, None])
            self._baseline_unfolded.clear()
        self.evaluations_total += 1
        reason = evaluate_canary(
            list(self._lat[BASELINE]), list(self._lat[CANDIDATE]),
            list(self._err[BASELINE]), list(self._err[CANDIDATE]),
            self._detector,
            min_samples=self.min_samples,
            outlier_fraction=self.outlier_fraction,
            max_error_rate_excess=self.max_error_rate_excess)
        if reason is not None:
            self.phase = ROLLED_BACK
            self.rollback_reason = reason
            self.rollbacks_total += 1
            logger.warning("canary ROLLED BACK: %s", reason)
        elif (self.promote_after
                and self.evaluations_total >= self.promote_after):
            self.phase = PROMOTED
            logger.info("canary PROMOTED after %d clean evaluations",
                        self.evaluations_total)

    # -- surfaces ----------------------------------------------------------
    def rollback(self, reason: str = "manual") -> None:
        """Operator-forced rollback (the manual override every automatic
        rollout system still needs)."""
        with self._lock:
            if self.phase != ROLLED_BACK:
                self.phase = ROLLED_BACK
                self.rollback_reason = reason
                self.rollbacks_total += 1

    def tags(self) -> Dict[str, Any]:
        out = super().tags()
        with self._lock:
            out.update({
                "canary_phase": self.phase,
                "canary_fraction": self.fraction,
                "canary_rollback_reason": self.rollback_reason,
            })
        return out

    def canary_stats(self) -> Dict[str, Any]:
        """Snapshot for ``MetricsRegistry.sync_controlplane`` (scrape
        thread)."""
        with self._lock:
            cand_err = (float(np.mean(self._err[CANDIDATE]))
                        if self._err[CANDIDATE] else 0.0)
            base_err = (float(np.mean(self._err[BASELINE]))
                        if self._err[BASELINE] else 0.0)
            return {
                "canary_phase": self.phase,
                "canary_phase_code": _PHASE_CODES[self.phase],
                "canary_fraction": self.fraction,
                "canary_routed_total": self._routed,
                "canary_evaluations_total": self.evaluations_total,
                "canary_rollbacks_total": self.rollbacks_total,
                "canary_baseline_error_rate": base_err,
                "canary_candidate_error_rate": cand_err,
            }


class ShadowNode(SeldonComponent):
    """Mirror traffic to a shadow candidate; serve only the primary.

    ``predict``/``generate`` always run the primary and return its
    response; every ``mirror_fraction``-th request (the same deterministic
    counter split as the canary) is ALSO sent to the shadow, whose
    response is compared — max-abs-diff for arrays, exact match for token
    lists — and discarded.  Shadow latency is measured on the injectable
    ``clock``; shadow exceptions increment a counter and are swallowed.
    The divergence record is the promotion evidence a canary phase then
    bets real traffic on."""

    def __init__(
        self,
        primary: Any,
        shadow: Any,
        mirror_fraction: float = 1.0,
        clock: Any = None,
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        import time

        self.primary = primary
        self.shadow = shadow
        self.mirror_fraction = float(mirror_fraction)
        self.clock = clock if clock is not None else time.perf_counter
        self._lock = threading.Lock()
        self._seen = 0
        self.mirrors_total = 0
        self.shadow_errors_total = 0
        self.divergences_total = 0
        self.max_abs_diff = 0.0
        self.latency_delta_s_sum = 0.0

    def load(self) -> None:
        for c in (self.primary, self.shadow):
            if hasattr(c, "load"):
                c.load()

    def _should_mirror(self) -> bool:
        with self._lock:
            n = self._seen
            self._seen += 1
        return canary_split(n, self.mirror_fraction) == CANDIDATE

    def _record(self, diverged: bool, diff: float, delta_s: float) -> None:
        with self._lock:
            self.mirrors_total += 1
            self.latency_delta_s_sum += delta_s
            if diverged:
                self.divergences_total += 1
            if diff > self.max_abs_diff:
                self.max_abs_diff = diff

    def _record_error(self) -> None:
        with self._lock:
            self.mirrors_total += 1
            self.shadow_errors_total += 1

    @staticmethod
    def _compare(a: Any, b: Any) -> float:
        """Output divergence as a max-abs-diff (arrays) or 0/inf exact
        match (anything else, token lists included)."""
        try:
            aa, bb = np.asarray(a, dtype=np.float64), np.asarray(
                b, dtype=np.float64)
            if aa.shape != bb.shape:
                return float("inf")
            if aa.size == 0:
                return 0.0
            return float(np.max(np.abs(aa - bb)))
        except (TypeError, ValueError):
            return 0.0 if a == b else float("inf")

    def _mirror(self, method: str, *args: Any, **kwargs: Any):
        import inspect

        t0 = self.clock()
        fn = getattr(self.primary, method)
        out = fn(*args, **kwargs)
        t1 = self.clock()
        if inspect.isawaitable(out):
            # async primary: the engine awaits the result downstream and
            # a sync wrapper cannot observe it — delegate without
            # mirroring rather than comparing un-run coroutines
            return out
        if self._should_mirror():
            try:
                s_out = getattr(self.shadow, method)(*args, **kwargs)
                t2 = self.clock()
                if inspect.isawaitable(s_out):
                    s_out.close()
                    raise TypeError(
                        f"async shadow component {type(self.shadow).__name__}"
                        " cannot be mirrored from a sync primary")
                diff = self._compare(out, s_out)
                self._record(diff != 0.0, 0.0 if diff == float("inf")
                             else diff, (t2 - t1) - (t1 - t0))
            except Exception:
                # the shadow exists to fail safely: record, never raise
                logger.exception("shadow %s failed", method)
                self._record_error()
        return out

    def predict(self, X, names, meta=None):
        return self._mirror("predict", X, names, meta)

    def generate(self, *args: Any, **kwargs: Any):
        return self._mirror("generate", *args, **kwargs)

    def tags(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "shadowing": type(self.shadow).__name__,
                "shadow_mirrors": self.mirrors_total,
                "shadow_divergences": self.divergences_total,
            }

    def shadow_stats(self) -> Dict[str, Any]:
        """Snapshot for ``MetricsRegistry.sync_controlplane``."""
        with self._lock:
            return {
                "shadow_mirrors_total": self.mirrors_total,
                "shadow_errors_total": self.shadow_errors_total,
                "shadow_divergences_total": self.divergences_total,
                "shadow_max_abs_diff": self.max_abs_diff,
                "shadow_latency_delta_s_sum": self.latency_delta_s_sum,
            }
