"""SLO-aware weighted-fair admission for the continuous batcher: a copy of
``seldon_core_tpu/runtime/scheduler.py`` (host-only), which replaces the
batcher's FIFO queue.

Requests carry a TENANT and an SLO CLASS, ``interactive`` (chat, agents)
or ``batch`` (evals, backfills), and admission order is decided by stride
scheduling (the deterministic form of weighted fair queueing):

- classes share the slots by weight: each class keeps a virtual time that
  advances by ``1/weight`` an admission, and the nonempty class with the
  smallest admits next (interactive 4 : batch 1 by default), so neither
  starves;
- tenants share a class the same way, under per-tenant weights;
- within a tenant, requests with a deadline order earliest first, the rest
  keep arrival order behind them;
- a class or tenant that sat idle banks no credit: on re-arrival its
  virtual time catches up to the last pick's;
- ``tenant_quota`` (global) / ``tenant_quotas[tenant]`` bound a tenant's
  QUEUED requests: a push over quota is refused, and the batcher sheds it
  with 503 + Retry-After;
- an interactive admission blocked by a staged batch-class prefill may
  push that job back (``push(requeue=True)``): it keeps its sequence
  number and is never preempted twice (the batcher decides, never for an
  active slot);
- past ``MAX_TENANT_SERIES`` distinct (tenant, class) tallies, unseen
  tenants fold into one overflow bucket, so a client-controlled header
  cannot grow the tallies or the metric series without bound.

Admissions, sheds and tokens are tallied per (tenant, class) and reach
``seldon_tenant_*_total`` through ``LLMServer.llm_stats``. Every public
method takes ``self._lock``: pushes come from transport threads, picks and
commits from the batcher's loop, reads from scrapes.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["PendingRequest", "WeightedFairScheduler", "normalize_slo_class",
           "INTERACTIVE", "BATCH", "SLO_CLASSES", "DEFAULT_CLASS_WEIGHTS"]

INTERACTIVE = "interactive"
BATCH = "batch"
SLO_CLASSES = (INTERACTIVE, BATCH)

# cardinality bound on per-tenant tracking (tallies + metrics series):
# the tenant header is client-controlled, so past this many distinct
# (tenant, class) tallies, unseen tenants fold into one shared bucket
# (WeightedFairScheduler._resolve_tenant)
MAX_TENANT_SERIES = 512
OVERFLOW_TENANT = "~other"

# interactive admits 4 slots for every 1 batch slot when both queues are
# nonempty — latency isolation with guaranteed batch progress
DEFAULT_CLASS_WEIGHTS = {INTERACTIVE: 4.0, BATCH: 1.0}


def normalize_slo_class(value) -> str:
    """Canonical SLO class; raises ValueError on anything else so a typo
    in a header/config fails loudly (400 at the transport, load() error
    for server config) instead of silently landing in a default queue."""
    v = str(value or INTERACTIVE).strip().lower()
    if v in (INTERACTIVE, "latency"):
        return INTERACTIVE
    if v in (BATCH, "throughput", "bulk"):
        return BATCH
    raise ValueError(
        f"unknown SLO class {value!r}: expected one of {SLO_CLASSES}")


@dataclasses.dataclass
class PendingRequest:
    """One queued admission. ``seq`` is assigned at first push and
    survives requeue, so a preempted request re-enters its tenant queue at
    its original position; ``deadline_t`` is on the batcher's perf_counter
    clock. ``resume_tokens`` > 0 marks a fleet resume: ``ids`` then carry
    the prompt and the tokens already delivered, and the first token's key
    is fast-forwarded past them. ``trace`` is the request's
    ``tracing.TraceContext`` from its ingress (or None): the flight
    recorder roots the request's timeline and span tree at it."""

    ids: List[int]
    max_new: int
    fut: Any
    on_token: Optional[Any] = None
    info: Optional[dict] = None
    seed: Optional[int] = None
    t_arrival: Optional[float] = None
    trace: Optional[Any] = None
    tenant: str = ""
    slo_class: str = INTERACTIVE
    deadline_t: Optional[float] = None
    adapter_id: int = 0
    seq: int = 0
    preempted: bool = False
    resume_tokens: int = 0

    def _order_key(self) -> Tuple[float, int]:
        # EDF within a tenant queue; deadline-less requests keep arrival
        # order after every deadline-carrying one
        dk = self.deadline_t if self.deadline_t is not None else math.inf
        return (dk, self.seq)


class _TenantTally:
    __slots__ = ("admitted", "shed", "tokens", "queued", "preempted")

    def __init__(self):
        self.admitted = 0
        self.shed = 0
        self.tokens = 0
        self.queued = 0
        self.preempted = 0


class WeightedFairScheduler:
    """See module docstring. ``class_weights`` / ``tenant_weights``
    override the defaults (missing tenants weigh 1); ``tenant_quota`` is
    the global per-tenant queued-request bound (0 = unbounded) with
    ``tenant_quotas`` per-tenant overrides."""

    def __init__(self, class_weights: Optional[Dict[str, float]] = None,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 tenant_quota: int = 0,
                 tenant_quotas: Optional[Dict[str, int]] = None):
        self._lock = threading.Lock()
        weights = dict(DEFAULT_CLASS_WEIGHTS)
        for cls, w in (class_weights or {}).items():
            cls = normalize_slo_class(cls)
            if float(w) <= 0:
                raise ValueError(f"class weight for {cls!r} must be > 0")
            weights[cls] = float(w)
        self._class_weights = weights
        self._tenant_weights = {str(t): float(w)
                                for t, w in (tenant_weights or {}).items()}
        self._tenant_quota = int(tenant_quota)
        self._tenant_quotas = {str(t): int(q)
                               for t, q in (tenant_quotas or {}).items()}
        # (cls, tenant) -> heap of (order_key, req); heaps hold only live
        # entries (commit removes by identity, not lazily)
        self._queues: Dict[Tuple[str, str], List[Tuple[Tuple[float, int],
                                                       int, PendingRequest]]] = {}
        self._class_vt: Dict[str, float] = {c: 0.0 for c in SLO_CLASSES}
        self._tenant_vt: Dict[Tuple[str, str], float] = {}
        # the virtual-time floor: a class/tenant going idle must not bank
        # credit — on re-arrival its vt catches up to the last pick's
        self._vt_floor = 0.0
        self._tenant_vt_floor: Dict[str, float] = {c: 0.0 for c in SLO_CLASSES}
        self._tenants: Dict[Tuple[str, str], _TenantTally] = {}
        self._seq = 0
        self._size = 0

    # ------------------------------------------------------------------
    def _resolve_tenant(self, tenant: str) -> str:
        """Bound the tenant cardinality the scheduler TRACKS: the tenant
        header is client-controlled, and without a cap every unique value
        would permanently allocate a tally and one more
        seldon_tenant_*_total{tenant=...} Prometheus series per scrape.
        Known tenants keep their own tallies; once MAX_TENANT_SERIES
        distinct (tenant, class) tallies exist, UNSEEN tenants fold into
        the shared OVERFLOW_TENANT bucket (quota then applies to the
        bucket in aggregate — deliberately conservative under a
        cardinality flood). Configure real tenants in tenant_weights /
        tenant_quotas and size the cap accordingly."""
        if ((tenant, INTERACTIVE) in self._tenants
                or (tenant, BATCH) in self._tenants):
            return tenant
        if len(self._tenants) >= MAX_TENANT_SERIES:
            return OVERFLOW_TENANT
        return tenant

    def _tally(self, tenant: str, cls: str) -> _TenantTally:
        tenant = self._resolve_tenant(tenant)
        t = self._tenants.get((tenant, cls))
        if t is None:
            t = self._tenants[(tenant, cls)] = _TenantTally()
        return t

    def _quota_of(self, tenant: str) -> int:
        return self._tenant_quotas.get(tenant, self._tenant_quota)

    # ------------------------------------------------------------------
    def push(self, req: PendingRequest, requeue: bool = False) -> bool:
        """Queue one request. Returns False — and counts the shed —
        when the tenant is over its queued-request quota (the batcher
        turns that into 503 + Retry-After). ``requeue=True`` is the
        preemption return path: quota is skipped (the request was
        already admitted once) and the original seq keeps its position."""
        with self._lock:
            cls = req.slo_class
            tenant = req.tenant
            tally = self._tally(tenant, cls)
            if not requeue:
                quota = self._quota_of(tenant)
                tracked = self._resolve_tenant(tenant)
                queued = sum(
                    t.queued for (tn, _), t in self._tenants.items()
                    if tn == tracked)
                if quota > 0 and queued >= quota:
                    tally.shed += 1
                    return False
                self._seq += 1
                req.seq = self._seq
            else:
                tally.preempted += 1
                req.preempted = True
            # idle catch-up BEFORE the push: a class/tenant that sat empty
            # must not bank virtual-time credit it would then spend
            # monopolizing admissions
            if self._class_empty(cls):
                self._class_vt[cls] = max(self._class_vt[cls], self._vt_floor)
            key = (cls, tenant)
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = []
            if not q:
                self._tenant_vt[key] = max(
                    self._tenant_vt.get(key, 0.0),
                    self._tenant_vt_floor[cls])
            heapq.heappush(q, (req._order_key(), req.seq, req))
            tally.queued += 1
            self._size += 1
            return True

    def _class_empty(self, cls: str) -> bool:
        return not any(q for (c, _), q in self._queues.items() if c == cls)

    # ------------------------------------------------------------------
    def next_request(self) -> Optional[PendingRequest]:
        """Peek the next admission per policy WITHOUT removing it — the
        batcher's peek-try-commit idiom (a failed admit keeps the
        request queued for the next loop turn)."""
        with self._lock:
            pick = self._pick_locked()
            return None if pick is None else pick[1][0][2]

    def _pick_locked(self):
        # class by min virtual time (nonempty only; tie -> interactive)
        best_cls = None
        for cls in SLO_CLASSES:
            if self._class_empty(cls):
                continue
            if best_cls is None or self._class_vt[cls] < self._class_vt[best_cls]:
                best_cls = cls
        if best_cls is None:
            return None
        # tenant within the class, same rule (tie -> lowest head seq so
        # the order is deterministic and arrival-respecting)
        best_key, best_q = None, None
        for key, q in self._queues.items():
            if key[0] != best_cls or not q:
                continue
            if best_key is None:
                best_key, best_q = key, q
                continue
            vt_a = self._tenant_vt.get(key, 0.0)
            vt_b = self._tenant_vt.get(best_key, 0.0)
            if vt_a < vt_b or (vt_a == vt_b and q[0][1] < best_q[0][1]):
                best_key, best_q = key, q
        return best_key, best_q

    def commit(self, req: PendingRequest) -> None:
        """Remove ``req`` (admitted into a slot / staged) and advance the
        virtual clocks — the other half of the peek-try-commit pair.
        Removal is by identity: a push that slipped in between the peek
        and this commit may have changed the head."""
        with self._lock:
            key = (req.slo_class, req.tenant)
            q = self._queues.get(key)
            if q is None:
                return
            # read BEFORE _remove_from: emptying the queue prunes the vt
            # entry, and the floors below must still see the advance
            old_vt = self._tenant_vt.get(key, 0.0)
            if not self._remove_from(key, q, req):
                return
            self._size -= 1
            tally = self._tally(req.tenant, req.slo_class)
            tally.queued = max(tally.queued - 1, 0)
            if not req.preempted:
                # a preempted request already counted at its FIRST
                # admission — admitted tallies unique requests, while the
                # virtual clocks below advance on every admission event
                # (the re-admission consumes class bandwidth again)
                tally.admitted += 1
            cls = req.slo_class
            self._class_vt[cls] += 1.0 / self._class_weights[cls]
            w = self._tenant_weights.get(req.tenant, 1.0)
            new_vt = old_vt + 1.0 / w
            self._vt_floor = max(self._vt_floor, self._class_vt[cls])
            self._tenant_vt_floor[cls] = max(self._tenant_vt_floor[cls],
                                             new_vt)
            if key in self._queues:  # still queued: keep the live vt
                self._tenant_vt[key] = new_vt

    def _remove_from(self, key, q, req) -> bool:
        """Identity-remove ``req`` from its tenant heap. The committed
        request is almost always the head next_request() just peeked, so
        the common case is one O(log n) heappop — the O(n) scan+heapify
        only runs when a racing push changed the head. Emptied heaps
        prune their map entries (client-controlled tenant names must not
        grow the maps unboundedly); the pruned virtual time is
        re-created AT THE FLOOR on re-arrival, which is exactly push()'s
        no-banked-credit catch-up."""
        if q and q[0][2] is req:
            heapq.heappop(q)
        else:
            for i, (_, _, r) in enumerate(q):
                if r is req:
                    q.pop(i)
                    heapq.heapify(q)
                    break
            else:
                return False
        if not q:
            del self._queues[key]
            self._tenant_vt.pop(key, None)
        return True

    def remove(self, req: PendingRequest) -> bool:
        """Drop a queued request without admitting it (quota-less shed
        paths; the crash drain uses drain_all). Counts the shed."""
        with self._lock:
            key = (req.slo_class, req.tenant)
            q = self._queues.get(key)
            if not q:
                return False
            if not self._remove_from(key, q, req):
                return False
            self._size -= 1
            tally = self._tally(req.tenant, req.slo_class)
            tally.queued = max(tally.queued - 1, 0)
            tally.shed += 1
            return True

    def drain_all(self) -> List[PendingRequest]:
        """Remove and return every queued request (batcher crash path:
        each one's future is failed)."""
        with self._lock:
            out: List[PendingRequest] = []
            for q in self._queues.values():
                out.extend(r for _, _, r in q)
            self._queues.clear()
            self._tenant_vt.clear()
            for tally in self._tenants.values():
                tally.queued = 0
            self._size = 0
            out.sort(key=lambda r: r.seq)
            return out

    # ------------------------------------------------------------------
    # accounting surface (batcher post-admission paths + metrics)
    # ------------------------------------------------------------------
    def count_shed(self, tenant: str, slo_class: str) -> None:
        """A post-admission shed (page exhaustion victim, staged-job
        shed) attributed to its tenant."""
        with self._lock:
            self._tally(tenant, slo_class).shed += 1

    def count_tokens(self, tenant: str, slo_class: str, n: int) -> None:
        with self._lock:
            self._tally(tenant, slo_class).tokens += int(n)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return self._size

    def depths(self) -> Dict[str, int]:
        """Queued requests per SLO class (the scaling snapshot's
        ``queue_by_class`` block)."""
        with self._lock:
            out = {c: 0 for c in SLO_CLASSES}
            for (cls, _), q in self._queues.items():
                out[cls] += len(q)
            return out

    def counters(self) -> List[Dict[str, Any]]:
        """Per-(tenant, class) lifetime tallies for llm_stats ->
        sync_llm -> seldon_tenant_*_total{tenant,slo_class}."""
        with self._lock:
            return [
                {"tenant": tenant, "slo_class": cls,
                 "admitted": t.admitted, "shed": t.shed,
                 "tokens": t.tokens, "queued": t.queued,
                 "preempted": t.preempted}
                for (tenant, cls), t in sorted(self._tenants.items())
            ]
