"""Prometheus metrics of the port, in the text exposition format.

Port of the part of ``seldon_core_tpu/metrics/registry.py`` whose sources
exist in the port: the API request counter and latency histogram, observed
by the REST and gRPC routes; the engine app's feedback and reward
counters, the resilience series (admission sheds, deadline expiries and
remaining budget, breaker state, transitions and rejections, in-flight and
queued requests) and the components' in-band custom metrics
(``register_custom``: each COUNTER / GAUGE / TIMER in a response's
``meta.metrics`` becomes a family of its own); and the LLM serving series that
``LLMServer.llm_stats`` feeds at scrape time (TTFT, inter-token gap, decode
step / dispatch / sync walls, host lag, steps in flight, the KV bytes,
occupancy and page pool, speculative decoding's acceptance counters, the
radix prefix cache's counters, the LoRA adapter pool's gauges, the
per-(tenant, SLO class) admission, shed and token tallies and the TTFT by
class); and the tracer's export series that ``tracing.Tracer.export_stats``
feeds at scrape time (spans dropped, export wall, request traces retained
by sampling mode); and the control plane's series that ``sync_controlplane``
reads from an autoscaler, a canary router and a shadow node (replicas,
draining replicas, applied scale events, canary phase, rollbacks and
branch error rates, shadow mirrors, divergences, errors and largest
divergence).
Names, types, label names, HELP text and bucket bounds are the JAX
package's, so a dashboard reads both. The JAX package builds on
prometheus_client; the card's machine has none, so this module writes the
format itself (``expose``), the same text on every machine.
"""

from __future__ import annotations

import bisect
import math
import os
import threading
from typing import Any, Dict, List, Sequence, Tuple

LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)
HOST_LAG_BUCKETS = (0, 1, 2, 3, 4, 6, 8, 16, 32)
_CUSTOM_KINDS = {"COUNTER": "counter", "GAUGE": "gauge", "TIMER": "histogram"}
# prometheus_client's default histogram buckets (the custom timers')
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0, 7.5,
                   10.0)
SPEC_ACCEPTED_BUCKETS = (1, 2, 3, 4, 5, 6, 8, 12, 16)

_BASE = ("deployment_name", "predictor_name")


def _go_float(v: float) -> str:
    """A sample value or bucket bound as the Prometheus text format writes
    it (prometheus_client's ``floatToGoString``)."""
    v = float(v)
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if math.isnan(v):
        return "NaN"
    s = repr(v)
    dot = s.find(".")
    if v > 0 and dot > 6:  # Go switches to exponents sooner than Python
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


class _Family:
    """One metric family: its label sets, each a value (counter, gauge) or
    per-bucket counts plus the sum (histogram). The registry's lock guards
    every read and write."""

    def __init__(self, name: str, help_text: str, kind: str, labelnames: Sequence[str],
                 buckets: Sequence[float] = ()):
        self.name = name
        self.help = help_text
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self.bounds = tuple(float(b) for b in buckets) + ((math.inf,) if buckets else ())
        self.children: Dict[Tuple[str, ...], Any] = {}

    def child(self, labels: Tuple[str, ...]):
        c = self.children.get(labels)
        if c is None:
            c = [0] * len(self.bounds) + [0.0] if self.kind == "histogram" else 0.0
            self.children[labels] = c
        return c

    def lines(self) -> List[str]:
        name = self.name if self.kind != "counter" else self.name + "_total"
        help_text = self.help.replace("\\", r"\\").replace("\n", r"\n")
        out = [f"# HELP {name} {help_text}", f"# TYPE {name} {self.kind}"]
        for labels, c in self.children.items():
            pairs = dict(zip(self.labelnames, labels))
            if self.kind != "histogram":
                out.append(f"{name}{self._labels(pairs)} {_go_float(c)}")
                continue
            cum = 0
            for bound, n in zip(self.bounds, c):
                cum += n
                out.append(f"{name}_bucket{self._labels(dict(pairs, le=_go_float(bound)))} "
                           f"{_go_float(cum)}")
            out.append(f"{name}_count{self._labels(pairs)} {_go_float(cum)}")
            out.append(f"{name}_sum{self._labels(pairs)} {_go_float(c[-1])}")
        return out

    @staticmethod
    def _labels(pairs: Dict[str, str]) -> str:
        if not pairs:
            return ""
        return "{" + ",".join(f'{k}="{_escape_label(str(v))}"'
                              for k, v in sorted(pairs.items())) + "}"


class MetricsRegistry:
    """The component and engine apps' series. ``observe_*``, ``sync_*``
    and ``register_custom`` may be called from any thread; ``expose``
    renders one consistent snapshot."""

    def __init__(self, deployment: str = "", predictor: str = ""):
        self.deployment = deployment or os.environ.get("DEPLOYMENT_NAME", "")
        self.predictor = predictor or os.environ.get("PREDICTOR_ID", "")
        self._lock = threading.Lock()
        self._families: List[_Family] = []

        def fam(name, help_text, kind, extra=(), buckets=()):
            f = _Family(name, help_text, kind, _BASE + tuple(extra), buckets)
            self._families.append(f)
            return f

        self._api = fam("seldon_api_executor_server_requests",
                        "API requests by method and code", "counter", ("method", "code"))
        self._latency = fam("seldon_api_executor_server_requests_seconds", "API latency",
                            "histogram", ("method",), LATENCY_BUCKETS)
        self._feedback = fam("seldon_api_model_feedback", "Feedback events", "counter")
        self._feedback_reward = fam("seldon_api_model_feedback_reward",
                                    "Cumulative feedback reward", "counter")
        # the resilience layer (runtime/resilience.py): sheds, deadlines,
        # breaker states and transitions, admission occupancy
        self._shed = fam("seldon_resilience_shed",
                         "Requests shed at admission (503 + Retry-After / RESOURCE_EXHAUSTED)",
                         "counter", ("transport",))
        self._deadline_exceeded = fam("seldon_resilience_deadline_exceeded",
                                      "Requests that exhausted their deadline budget", "counter",
                                      ("transport",))
        self._breaker_state = fam("seldon_resilience_breaker_state",
                                  "Per-node circuit breaker state (0 closed, 1 half-open, 2 open)",
                                  "gauge", ("node",))
        self._breaker_transitions = fam("seldon_resilience_breaker_transitions",
                                        "Per-node circuit breaker transitions by target state",
                                        "counter", ("node", "to"))
        self._breaker_rejected = fam("seldon_resilience_breaker_rejected",
                                     "Calls rejected by an open circuit breaker", "counter",
                                     ("node",))
        self._inflight = fam("seldon_resilience_inflight", "Admitted requests currently in flight",
                             "gauge", ("transport",))
        self._queue_depth = fam("seldon_resilience_queue_depth",
                                "Requests waiting in the admission queue", "gauge", ("transport",))
        self._remaining_budget = fam("seldon_resilience_remaining_budget_seconds",
                                     "Deadline budget remaining at response time", "histogram",
                                     buckets=LATENCY_BUCKETS)
        # custom in-band metrics, a family each, keyed by name and tag set
        self._custom: Dict[str, _Family] = {}
        self._bound_breakers: set = set()
        self._kv_cache_bytes = fam("seldon_llm_kv_cache_bytes",
                                   "Resident KV-cache bytes (continuous-batching slot caches + "
                                   "pinned prefix-cache entries)", "gauge")
        self._kv_occupancy = fam("seldon_llm_kv_cache_occupancy",
                                 "Fraction of continuous-batching cache slots occupied (0-1)",
                                 "gauge")
        self._kv_bytes_per_step = fam("seldon_llm_kv_bytes_per_step",
                                      "KV-cache bytes streamed from HBM per decode step (dense "
                                      "attention reads the whole static cache every step)",
                                      "gauge")
        self._kv_pages_in_use = fam("seldon_llm_kv_pages_in_use",
                                    "KV pages currently allocated to slots (paged layout)",
                                    "gauge")
        self._kv_pages_total = fam("seldon_llm_kv_pages_total",
                                   "Total KV pages in the global pool (incl. the 2 reserved "
                                   "pages)", "gauge")
        self._kv_page_fragmentation = fam("seldon_llm_kv_page_fragmentation",
                                          "Internal fragmentation of allocated KV pages "
                                          "(1 - tokens written / page tokens held, 0-1)", "gauge")
        self._kv_page_sheds = fam("seldon_llm_kv_page_sheds",
                                  "Requests shed (503 + Retry-After / RESOURCE_EXHAUSTED) by KV "
                                  "page-pool exhaustion", "counter")
        # the radix prefix cache: hit blocks (block-table entries written
        # instead of prefilled), pages live slots share now, CoW copies,
        # evictions, and the KV bytes hits neither recomputed nor copied
        self._prefix_hit_blocks = fam("seldon_llm_prefix_hit_blocks",
                                      "Cached KV blocks served by radix prefix-cache hits (block-"
                                      "table entries written instead of prefilled)", "counter")
        self._prefix_shared_pages = fam("seldon_llm_prefix_shared_pages",
                                        "Cached pages currently referenced by at least one live "
                                        "slot (refcount > 1; sampled at scrape)", "gauge")
        self._prefix_cached_blocks = fam("seldon_llm_prefix_cached_blocks",
                                         "Token blocks resident in the radix prefix trie (sampled "
                                         "at scrape)", "gauge")
        self._prefix_cow_copies = fam("seldon_llm_prefix_cow_copies",
                                      "Copy-on-write page copies (a slot continuing part-way into "
                                      "a shared block pays one page copy)", "counter")
        self._prefix_evicted_blocks = fam("seldon_llm_prefix_evicted_blocks",
                                          "Trie blocks evicted (LRU-by-leaf on pool pressure, plus "
                                          "in-place upgrades/clears)", "counter")
        self._prefix_bytes_saved = fam("seldon_llm_prefix_bytes_saved",
                                       "KV bytes radix hits served by sharing pages in place "
                                       "(bytes neither recomputed by prefill nor copied)",
                                       "counter")
        self._decode_step = fam("seldon_llm_decode_step_seconds", "LLM decode step latency",
                                "histogram", buckets=LATENCY_BUCKETS)
        self._ttft = fam("seldon_llm_ttft_seconds",
                         "Time from request submission to its first generated token "
                         "(batcher path)", "histogram", buckets=LATENCY_BUCKETS)
        self._inter_token = fam("seldon_llm_inter_token_seconds",
                                "Gap before each surfaced token (batcher on_token path; "
                                "fused/speculative blocks surface as bursts)", "histogram",
                                buckets=LATENCY_BUCKETS)
        self._decode_dispatch = fam("seldon_llm_decode_dispatch_seconds",
                                    "Decode step dispatch wall (enqueue-only; the host does not "
                                    "wait for tokens)", "histogram", buckets=LATENCY_BUCKETS)
        self._decode_sync = fam("seldon_llm_decode_sync_seconds",
                                "Host sync wall per drain (blocked reading the oldest "
                                "in-flight step's tokens)", "histogram", buckets=LATENCY_BUCKETS)
        self._decode_steps_in_flight = fam("seldon_llm_decode_steps_in_flight",
                                           "Decode steps currently dispatched ahead of the host "
                                           "(sampled at scrape)", "gauge")
        self._decode_host_lag = fam("seldon_llm_decode_host_lag_steps",
                                    "Steps the host trailed the device at each drain (>=2 means "
                                    "the pipeline is actually ahead)", "histogram",
                                    buckets=HOST_LAG_BUCKETS)

        # disaggregated prefill/decode (runtime/disagg.py): the per-handoff
        # wall, handoffs delivered, the staged + ready backlog, and the
        # bytes the network transport received
        self._handoff = fam("seldon_llm_handoff_seconds",
                            "Per-admission prefill handoff wall: prefill-slice compute + D2D "
                            "transfer + decode-side page import", "histogram",
                            buckets=LATENCY_BUCKETS)
        self._handoffs_total = fam("seldon_llm_handoffs",
                                   "Prefill->decode KV handoffs delivered (disaggregated serving)",
                                   "counter")
        self._handoff_queue_depth = fam("seldon_llm_handoff_queue_depth",
                                        "Admissions staged on the prefill slice or awaiting "
                                        "import (sampled at scrape)", "gauge")
        self._handoff_network_bytes = fam("seldon_llm_handoff_network_bytes",
                                          "KV handoff frame bytes received over the network "
                                          "transport (handoff_transport='network'; 0 on the "
                                          "device_put fast path)", "counter")

        # speculative decoding: accept rate and tokens per verify forward
        # (> 1 = more than one token a KV-cache read), the per-slot EMA the
        # draft-length controller steers by, the draft overhead
        self._spec_accept_rate = fam("seldon_llm_spec_accept_rate",
                                     "Aggregate draft-token acceptance rate (accepted drafts / "
                                     "offered drafts, 0-1)", "gauge")
        self._spec_accept_rate_slot = fam("seldon_llm_spec_accept_rate_per_slot",
                                          "Per-slot draft acceptance-rate EMA (the draft-length "
                                          "controller's steering signal)", "gauge", ("slot",))
        self._spec_tokens_per_forward = fam("seldon_llm_spec_tokens_per_forward",
                                            "Accepted tokens per verify forward (>1 = more than "
                                            "one token per KV-cache read)", "gauge")
        self._spec_accepted = fam("seldon_llm_spec_accepted_tokens_per_step",
                                  "Tokens emitted by each drained verify step (1..K+1)",
                                  "histogram", buckets=SPEC_ACCEPTED_BUCKETS)
        self._spec_draft_overhead = fam("seldon_llm_spec_draft_overhead_fraction",
                                        "Fraction of verify-forward token columns wasted on drafts "
                                        "that lost verification (0-1)", "gauge")
        self._spec_slot_steps = fam("seldon_llm_spec_slot_verify_steps",
                                    "Per-slot verify steps drained: each verify forward "
                                    "contributes one per active slot (divide by the active-slot "
                                    "count for the forward/program count)", "counter")
        # multi-tenant serving: the adapter pool's occupancy, churn and
        # bytes; per-(tenant, class) admissions, sheds and tokens; TTFT by
        # class
        self._adapter_loaded = fam("seldon_llm_adapter_loaded",
                                   "LoRA adapters currently resident in the dense pool "
                                   "(identity row excluded)", "gauge")
        self._adapter_evictions = fam("seldon_llm_adapter_evictions",
                                      "Adapters evicted from the pool (refcount-zero rows freed "
                                      "for reuse)", "counter")
        self._adapter_pool_bytes = fam("seldon_llm_adapter_pool_bytes",
                                       "HBM bytes held by the dense LoRA adapter pool (all rows, "
                                       "loaded or free)", "gauge")
        tenant_labels = ("tenant", "slo_class")
        self._tenant_admitted = fam("seldon_tenant_admitted",
                                    "Requests admitted into the continuous batch, by tenant and "
                                    "SLO class", "counter", tenant_labels)
        self._tenant_shed = fam("seldon_tenant_shed",
                                "Requests shed (quota breach at push, page-exhaustion victim, "
                                "staged-job shed), by tenant and SLO class", "counter",
                                tenant_labels)
        self._tenant_tokens = fam("seldon_tenant_tokens",
                                  "Tokens generated and credited, by tenant and SLO class",
                                  "counter", tenant_labels)
        # the replica fleet's fault tolerance (runtime/engine.ReplicaSet's
        # fleet_* tallies): ejections of dead replicas, reinstatements by a
        # half-open probe, resumes and the tokens they skipped, refusals of a
        # spent retry budget, and the journal entries open
        self._fleet_ejections = fam(
            "seldon_fleet_ejections", "Replicas ejected from fleet dispatch after an unplanned "
            "death (crashed or wedged batcher loop, consecutive dispatch failures)", "counter")
        self._fleet_reinstatements = fam(
            "seldon_fleet_reinstatements", "Ejected replicas reinstated into fleet dispatch after "
            "a successful half-open probe", "counter")
        self._fleet_resumes = fam(
            "seldon_fleet_resumes", "In-flight generations resumed bit-exactly on a surviving "
            "replica after their replica died mid-stream", "counter")
        self._fleet_resumed_tokens = fam(
            "seldon_fleet_resumed_tokens", "Tokens already delivered at resume time (skipped, "
            "never re-sent: the at-most-once streaming contract)", "counter")
        self._fleet_budget_exhausted = fam(
            "seldon_fleet_retry_budget_exhausted", "Recoveries refused because the fleet retry "
            "budget was exhausted (degraded to 503 + Retry-After instead of amplifying load)",
            "counter")
        self._fleet_journal_depth = fam(
            "seldon_fleet_resume_journal_depth", "Fleet resume-journal entries currently open "
            "(fleet generations in flight with recovery records)", "gauge")
        # the tracer (tracing/__init__.py, runtime/flight.py): spans lost to
        # failed exports (a batch is re-enqueued once, the second failure
        # drops it), each flush's export wall, and the request trees the
        # flight recorder retained ('head' = the inbound sampled flag,
        # 'tail' = past an unsampled flag by the latency thresholds)
        self._trace_spans_dropped = fam(
            "seldon_trace_spans_dropped", "Trace spans dropped after a failed OTLP export's "
            "single bounded re-enqueue", "counter")
        self._trace_export = fam("seldon_trace_export_seconds",
                                 "OTLP trace export latency per flush (success or failure)",
                                 "histogram", buckets=LATENCY_BUCKETS)
        self._traces_retained = fam(
            "seldon_llm_traces_retained", "Request traces materialized and exported, by sampling "
            "mode (head = inbound sampled flag; tail = latency-threshold retention of an "
            "unsampled request)", "counter", ("mode",))
        # the control plane (controlplane/autoscaler.py, analytics/canary.py):
        # the fleet shape the autoscaler drives and the actions it applied,
        # the canary's phase, rollbacks and branch error rates, the shadow's
        # mirrors, divergences and errors; synced at scrape time
        self._autoscaler_replicas = fam(
            "seldon_autoscaler_replicas", "Replicas currently attached to the autoscaled "
            "ReplicaSet (draining included until detach)", "gauge")
        self._autoscaler_draining = fam(
            "seldon_autoscaler_draining_replicas", "Replicas draining toward detach (no fleet "
            "traffic; in-flight work completing)", "gauge")
        self._autoscaler_events = fam(
            "seldon_autoscaler_scale_events", "Autoscaler actions applied, by kind (scale_up / "
            "scale_down / rebalance / collect)", "counter", ("action",))
        self._canary_phase = fam(
            "seldon_canary_phase", "Canary rollout phase per router node (0 canary, 1 promoted, "
            "2 rolled back)", "gauge", ("node",))
        self._canary_rollbacks = fam("seldon_canary_rollbacks",
                                     "Automatic or manual canary rollbacks", "counter", ("node",))
        self._canary_error_rate = fam(
            "seldon_canary_error_rate", "Windowed error rate per canary branch (baseline / "
            "candidate)", "gauge", ("node", "branch"))
        self._shadow_mirrors = fam(
            "seldon_shadow_mirrors", "Requests mirrored to a shadow candidate (responses "
            "discarded)", "counter", ("node",))
        self._shadow_divergences = fam(
            "seldon_shadow_divergences", "Mirrored requests whose shadow output diverged from "
            "the primary's", "counter", ("node",))
        self._shadow_errors = fam(
            "seldon_shadow_errors", "Shadow-side failures (swallowed — the client never sees "
            "them)", "counter", ("node",))
        self._shadow_max_diff = fam(
            "seldon_shadow_max_abs_diff", "Largest absolute output divergence observed on the "
            "shadow path", "gauge", ("node",))
        self._tenant_ttft = fam("seldon_llm_tenant_ttft_seconds",
                                "Time to first token by SLO class (the interactive-isolation "
                                "signal bench phase L gates on)", "histogram", ("slo_class",),
                                LATENCY_BUCKETS)

    def _base(self) -> Tuple[str, str]:
        return (self.deployment, self.predictor)

    @staticmethod
    def _observe(fam: _Family, labels: Tuple[str, ...], value: float) -> None:
        c = fam.child(labels)
        c[bisect.bisect_left(fam.bounds, value)] += 1
        c[-1] += value

    def observe_api_call(self, method: str, code: str, seconds: float) -> None:
        """One request of ``method`` answered ``code`` after ``seconds``."""
        with self._lock:
            key = self._base() + (method, str(code))
            self._api.children[key] = self._api.child(key) + 1.0
            self._observe(self._latency, self._base() + (method,), seconds)

    def observe_prediction(self, engine: Any, response: Any, seconds: float) -> None:
        """One engine prediction answered 200, and its in-band metrics."""
        self.observe_api_call("predictions", "200", seconds)
        self.register_custom(response)

    def observe_feedback(self, feedback: Any) -> None:
        with self._lock:
            base = self._base()
            self._feedback.children[base] = self._feedback.child(base) + 1.0
            if feedback.reward:
                self._feedback_reward.children[base] = (self._feedback_reward.child(base)
                                                        + abs(feedback.reward))

    def observe_deadline_exceeded(self, transport: str) -> None:
        with self._lock:
            key = self._base() + (transport,)
            self._deadline_exceeded.children[key] = self._deadline_exceeded.child(key) + 1.0

    def observe_remaining_budget(self, seconds: float) -> None:
        with self._lock:
            self._observe(self._remaining_budget, self._base(), max(seconds, 0.0))

    def sync_resilience(self, engine: Any = None, admission: Any = None,
                        transport: str = "rest") -> None:
        """Refresh the breaker and admission series at scrape time; each
        breaker's transition callback is wired to the transitions counter
        on first sight (idempotent)."""
        base = self._base()
        if engine is not None and hasattr(engine, "breakers"):
            for node, breaker in engine.breakers():
                if id(breaker) not in self._bound_breakers:
                    self._bound_breakers.add(id(breaker))

                    def on_transition(name, to):
                        with self._lock:
                            key = base + (name, to)
                            fam = self._breaker_transitions
                            fam.children[key] = fam.child(key) + 1.0

                    breaker.on_transition = on_transition
                state = float(breaker.state_code())
                with self._lock:
                    self._breaker_state.children[base + (node,)] = state
                    key = base + (node,)
                    self._breaker_rejected.children[key] = max(
                        self._breaker_rejected.child(key), float(breaker.rejected_total))
        if admission is not None:
            depth = float(admission.queue_depth())
            with self._lock:
                key = base + (transport,)
                self._inflight.children[key] = float(admission.inflight)
                self._queue_depth.children[key] = depth
                self._shed.children[key] = max(self._shed.child(key), float(admission.shed_total))

    def register_custom(self, response: Any) -> None:
        """Register the COUNTER / GAUGE / TIMER metrics carried in a
        response's meta: a family each, named by the metric's key, labelled
        by its tags (no deployment labels), as prometheus_client builds
        them in the JAX package. TIMER values arrive in milliseconds."""
        with self._lock:
            for m in response.meta.metrics:
                tags = dict(sorted(m.tags.items()))
                key = m.key + "|" + ",".join(f"{k}={v}" for k, v in tags.items())
                fam = self._custom.get(key)
                if fam is None:
                    kind = _CUSTOM_KINDS.get(m.type)
                    if kind is None:
                        continue
                    name = m.key[:-len("_total")] if (kind == "counter"
                                                      and m.key.endswith("_total")) else m.key
                    if any(f.name == name for f in self._families):
                        raise ValueError(f"Duplicated timeseries in CollectorRegistry: {name}")
                    fam = _Family(name, f"custom {m.type.lower()}", kind, tuple(tags),
                                  DEFAULT_BUCKETS if kind == "histogram" else ())
                    if not tags:
                        fam.child(())  # an unlabelled family shows 0 from its creation
                    self._custom[key] = fam
                    self._families.append(fam)
                labels = tuple(str(v) for v in tags.values())
                if fam.kind == "counter":
                    fam.children[labels] = fam.child(labels) + float(m.value)
                elif fam.kind == "gauge":
                    fam.children[labels] = float(m.value)
                else:
                    self._observe(fam, labels, float(m.value) / 1000.0)

    def sync_llm(self, component: Any) -> None:
        """Refresh the LLM series from ``component.llm_stats()`` (a no-op
        for a component without it): gauges set, the page-shed counter
        caught up to the allocator's tally (the spec slot-step counter to
        the controller's, the prefix counters to the trie's), and each
        drained observation observed once. A replica fleet
        (``runtime/engine.ReplicaSet``) is read through its merged
        ``llm_stats``, as a solo server is."""
        stats_fn = getattr(component, "llm_stats", None)
        if stats_fn is None:
            return
        stats = stats_fn()
        base = self._base()
        with self._lock:
            for fam, key in ((self._kv_cache_bytes, "kv_cache_bytes"),
                             (self._kv_occupancy, "kv_occupancy"),
                             (self._kv_bytes_per_step, "kv_bytes_per_step"),
                             (self._kv_pages_in_use, "kv_pages_in_use"),
                             (self._kv_pages_total, "kv_pages_total"),
                             (self._kv_page_fragmentation, "kv_page_fragmentation"),
                             (self._prefix_shared_pages, "prefix_shared_pages"),
                             (self._prefix_cached_blocks, "prefix_cached_blocks"),
                             (self._handoff_queue_depth, "handoff_queue_depth"),
                             (self._fleet_journal_depth, "fleet_resume_journal_depth")):
                fam.children[base] = float(stats.get(key, 0))
            # counters catch up to the lifetime tallies (never count down)
            for fam, key in ((self._kv_page_sheds, "kv_page_sheds"),
                             (self._prefix_hit_blocks, "prefix_hit_blocks"),
                             (self._prefix_cow_copies, "prefix_cow_copies"),
                             (self._prefix_evicted_blocks, "prefix_evicted_blocks"),
                             (self._prefix_bytes_saved, "prefix_bytes_saved"),
                             (self._handoffs_total, "handoffs_total"),
                             (self._handoff_network_bytes, "handoff_network_bytes_total"),
                             (self._fleet_ejections, "fleet_ejections_total"),
                             (self._fleet_reinstatements, "fleet_reinstatements_total"),
                             (self._fleet_resumes, "fleet_resumes_total"),
                             (self._fleet_resumed_tokens, "fleet_resumed_tokens_total"),
                             (self._fleet_budget_exhausted,
                              "fleet_retry_budget_exhausted_total")):
                fam.children[base] = max(fam.child(base), float(stats.get(key, 0)))
            for fam, key in ((self._decode_step, "decode_step_times_s"),
                             (self._ttft, "ttft_s"),
                             (self._inter_token, "inter_token_s"),
                             (self._decode_dispatch, "decode_dispatch_times_s"),
                             (self._decode_sync, "decode_sync_times_s"),
                             (self._decode_host_lag, "decode_host_lag_steps"),
                             (self._handoff, "handoff_times_s")):
                fam.child(base)
                for v in stats.get(key, ()):
                    self._observe(fam, base, v)
            self._decode_steps_in_flight.children[base] = float(
                stats.get("decode_steps_in_flight", 0))
            for fam, key in ((self._spec_accept_rate, "spec_accept_rate"),
                             (self._spec_tokens_per_forward, "spec_tokens_per_forward"),
                             (self._spec_draft_overhead, "spec_draft_overhead_fraction")):
                fam.children[base] = float(stats.get(key, 0.0))
            for slot, rate in enumerate(stats.get("spec_accept_rate_per_slot", ())):
                self._spec_accept_rate_slot.children[base + (str(slot),)] = float(rate)
            self._spec_accepted.child(base)
            for v in stats.get("spec_accepted_per_step", ()):
                self._observe(self._spec_accepted, base, v)
            self._spec_slot_steps.children[base] = max(
                self._spec_slot_steps.child(base), float(stats.get("spec_slot_steps_total", 0)))
            self._adapter_loaded.children[base] = float(stats.get("adapter_loaded", 0))
            self._adapter_pool_bytes.children[base] = float(stats.get("adapter_pool_bytes", 0))
            self._adapter_evictions.children[base] = max(
                self._adapter_evictions.child(base),
                float(stats.get("adapter_evictions_total", 0)))
            # a replica fleet's merged stats carry one row per replica for a
            # (tenant, class): the series is their sum
            tallies: Dict[Tuple[str, ...], List[float]] = {}
            for row in stats.get("tenant_counters", ()):
                labels = base + (row.get("tenant", ""), row.get("slo_class", ""))
                t = tallies.setdefault(labels, [0.0, 0.0, 0.0])
                for j, key in enumerate(("admitted", "shed", "tokens")):
                    t[j] += float(row.get(key, 0))
            for labels, t in tallies.items():
                for fam, v in zip((self._tenant_admitted, self._tenant_shed,
                                   self._tenant_tokens), t):
                    fam.children[labels] = max(fam.child(labels), v)
            for cls, seconds in stats.get("ttft_by_class", ()):
                self._observe(self._tenant_ttft, base + (cls,), seconds)

    def sync_tracing(self, tracer: Any = None) -> None:
        """Refresh the trace series from ``tracer`` (default: the process's)
        at scrape time: export walls drained (each observed once), the
        dropped and retained counters caught up to the tracer's lifetime
        tallies."""
        if tracer is None:
            from seldon_core_tpu_torch.tracing import get_tracer

            tracer = get_tracer()
        stats = tracer.export_stats()
        base = self._base()
        with self._lock:
            self._trace_export.child(base)
            for seconds in stats.get("export_times_s", ()):
                self._observe(self._trace_export, base, seconds)
            self._trace_spans_dropped.children[base] = max(
                self._trace_spans_dropped.child(base), float(stats.get("spans_dropped_total", 0)))
            for mode, total in (stats.get("retained_total") or {}).items():
                key = base + (str(mode),)
                self._traces_retained.children[key] = max(self._traces_retained.child(key),
                                                          float(total))

    def sync_controlplane(self, source: Any = None) -> None:
        """Refresh the autoscaler, canary and shadow series at scrape time.
        ``source`` is an engine (its graph's components are walked for
        ``canary_stats`` and ``shadow_stats``, and ``engine.autoscaler``
        read), a bare component (a fleet with an ``autoscaler`` attribute
        among them), or an Autoscaler; anything without those surfaces is
        a no-op. Counters catch up to the sources' lifetime tallies."""
        if source is None:
            return
        named = []  # (node label, object)
        state = getattr(source, "state", None)
        if state is not None and hasattr(state, "walk"):
            named = [(u.name, u.component) for u in state.walk() if u.component is not None]
        else:
            named.append((getattr(source, "name", "") or "", source))
        autoscalers = [a for a in (source, getattr(source, "autoscaler", None))
                       if a is not None and hasattr(a, "autoscaler_stats")]
        base = self._base()

        def catch_up(fam: _Family, key: Tuple[str, ...], value: float) -> None:
            fam.children[key] = max(fam.child(key), float(value))

        # the sources' stats take their own locks: read them before ours
        auto_stats = [a.autoscaler_stats() for a in autoscalers]
        node_stats = [(node, getattr(c, "canary_stats", lambda: None)(),
                       getattr(c, "shadow_stats", lambda: None)()) for node, c in named]
        with self._lock:
            for stats in auto_stats:
                self._autoscaler_replicas.children[base] = float(
                    stats.get("autoscaler_replicas", 0))
                self._autoscaler_draining.children[base] = float(
                    stats.get("autoscaler_draining", 0))
                for action, key in (("scale_up", "autoscaler_scale_ups_total"),
                                    ("scale_down", "autoscaler_scale_downs_total"),
                                    ("rebalance", "autoscaler_rebalances_total"),
                                    ("collect", "autoscaler_collected_total")):
                    catch_up(self._autoscaler_events, base + (action,), stats.get(key, 0))
            for node, canary, shadow in node_stats:
                if canary is not None:
                    self._canary_phase.children[base + (node,)] = float(
                        canary.get("canary_phase_code", 0))
                    catch_up(self._canary_rollbacks, base + (node,),
                             canary.get("canary_rollbacks_total", 0))
                    for branch, key in (("baseline", "canary_baseline_error_rate"),
                                        ("candidate", "canary_candidate_error_rate")):
                        self._canary_error_rate.children[base + (node, branch)] = float(
                            canary.get(key, 0.0))
                if shadow is not None:
                    key = base + (node,)
                    catch_up(self._shadow_mirrors, key, shadow.get("shadow_mirrors_total", 0))
                    catch_up(self._shadow_divergences, key,
                             shadow.get("shadow_divergences_total", 0))
                    catch_up(self._shadow_errors, key, shadow.get("shadow_errors_total", 0))
                    self._shadow_max_diff.children[key] = float(
                        shadow.get("shadow_max_abs_diff", 0.0))

    def expose(self) -> bytes:
        """Every family in the Prometheus text format (version 0.0.4)."""
        with self._lock:
            lines = [line for fam in self._families for line in fam.lines()]
        return ("\n".join(lines) + "\n").encode()


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

__all__ = ["CONTENT_TYPE", "DEFAULT_BUCKETS", "HOST_LAG_BUCKETS", "LATENCY_BUCKETS",
           "MetricsRegistry", "SPEC_ACCEPTED_BUCKETS"]
