"""The port's scrape routes and metrics (``seldon_core_tpu_torch/metrics/
registry.py``, ``LLMServer.llm_stats``, ``transport/rest.py`` ``/metrics``,
``/prometheus``, ``/seldon.json``) against the JAX package, on the CPU:

- fed the same observations, the port's text (its own writer of the
  Prometheus format), parsed with ``prometheus_client.parser``, equals the
  JAX registry's on every family the port emits (names, types, HELP,
  label names and values, bucket bounds, counts and sums); the JAX side is
  fed through ``sync_llm`` on a stub whose ``llm_stats`` returns the same
  dict; the port emits exactly the families whose source it has;
- the same requests to the JAX app and the port's app count the same
  request series by method and code;
- ``llm_stats``' speculation fields are zeros with speculation off; with
  it on, a scrape after a request shows the ``seldon_llm_spec_*`` series
  the batcher counted (the verify steps, each one's accepted tokens);
- live, after streams through the batcher: one scrape shows TTFT count =
  requests, inter-token count = credited tokens less one a request, page
  gauges = ``page_stats()``; ``llm_stats`` drains, so the next scrape adds
  nothing; ``/prometheus`` serves the same text and ``/seldon.json`` the JAX
  package's ``wrapper_spec``;
- with the prefix cache on, after a chat whose second turn hits the trie,
  one scrape's ``seldon_llm_prefix_*`` and ``seldon_llm_kv_*`` values equal
  ``llm_stats`` (and the JAX registry's text for that snapshot)."""

import asyncio
import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from aiohttp import web
from prometheus_client.parser import text_string_to_metric_families

import jax

from seldon_core_tpu.metrics.registry import MetricsRegistry as JaxRegistry
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu.transport.openapi import wrapper_spec as jax_wrapper_spec
from seldon_core_tpu.transport.rest import make_component_app as jax_app
from seldon_core_tpu_torch.metrics.registry import MetricsRegistry
from seldon_core_tpu_torch.servers.llmserver import LLMServer
from seldon_core_tpu_torch.transport.rest import make_component_app, start

KW = dict(vocab_size=256, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=64, dtype="float32")
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=6, len_buckets=(16,),
              batch_buckets=(1, 4), temperature=0.0, eos_id=-1, seed=3, continuous_batching=2)
TIMEOUT = 60

PORT_FAMILIES = {
    "seldon_api_executor_server_requests", "seldon_api_executor_server_requests_seconds",
    "seldon_llm_kv_pages_in_use", "seldon_llm_kv_pages_total", "seldon_llm_kv_page_sheds",
    "seldon_llm_decode_step_seconds", "seldon_llm_ttft_seconds",
    "seldon_llm_inter_token_seconds", "seldon_llm_decode_dispatch_seconds",
    "seldon_llm_decode_sync_seconds", "seldon_llm_decode_steps_in_flight",
    "seldon_llm_decode_host_lag_steps", "seldon_llm_spec_accept_rate",
    "seldon_llm_spec_accept_rate_per_slot", "seldon_llm_spec_tokens_per_forward",
    "seldon_llm_spec_accepted_tokens_per_step", "seldon_llm_spec_draft_overhead_fraction",
    "seldon_llm_spec_slot_verify_steps", "seldon_llm_kv_cache_bytes",
    "seldon_llm_kv_cache_occupancy", "seldon_llm_kv_bytes_per_step",
    "seldon_llm_kv_page_fragmentation", "seldon_llm_prefix_hit_blocks",
    "seldon_llm_prefix_shared_pages", "seldon_llm_prefix_cached_blocks",
    "seldon_llm_prefix_cow_copies", "seldon_llm_prefix_evicted_blocks",
    "seldon_llm_prefix_bytes_saved", "seldon_llm_adapter_loaded",
    "seldon_llm_adapter_evictions", "seldon_llm_adapter_pool_bytes", "seldon_tenant_admitted",
    "seldon_tenant_shed", "seldon_tenant_tokens", "seldon_llm_tenant_ttft_seconds",
    # the disaggregation slice's: the handoff series
    "seldon_llm_handoff_seconds", "seldon_llm_handoffs", "seldon_llm_handoff_queue_depth",
    "seldon_llm_handoff_network_bytes",
    # the fleet fault-tolerance slice's: ReplicaSet's fleet_* tallies
    "seldon_fleet_ejections", "seldon_fleet_reinstatements", "seldon_fleet_resumes",
    "seldon_fleet_resumed_tokens", "seldon_fleet_retry_budget_exhausted",
    "seldon_fleet_resume_journal_depth",
    # the control-plane slice's: the autoscaler, canary and shadow series
    # (empty until a sync_controlplane)
    "seldon_autoscaler_replicas", "seldon_autoscaler_draining_replicas",
    "seldon_autoscaler_scale_events", "seldon_canary_phase", "seldon_canary_rollbacks",
    "seldon_canary_error_rate", "seldon_shadow_mirrors", "seldon_shadow_divergences",
    "seldon_shadow_errors", "seldon_shadow_max_abs_diff",
    # the tracing slice's: the tracer's export series (empty until a
    # sync_tracing)
    "seldon_trace_spans_dropped", "seldon_trace_export_seconds", "seldon_llm_traces_retained",
    # the engine slice's: feedback, resilience
    "seldon_api_model_feedback", "seldon_api_model_feedback_reward", "seldon_resilience_shed",
    "seldon_resilience_deadline_exceeded", "seldon_resilience_breaker_state",
    "seldon_resilience_breaker_transitions", "seldon_resilience_breaker_rejected",
    "seldon_resilience_inflight", "seldon_resilience_queue_depth",
    "seldon_resilience_remaining_budget_seconds",
}


def families(text):
    return {f.name: f for f in text_string_to_metric_families(text)}


def stats(seed, sheds):
    """One ``llm_stats`` snapshot with random series (a fresh dict a call:
    ``sync_llm`` consumes it)."""
    rng = np.random.default_rng(seed)
    return {
        "kv_pages_total": 66, "kv_pages_in_use": int(rng.integers(0, 64)), "kv_page_size": 64,
        "kv_page_sheds": sheds, "kv_page_fragmentation": float(rng.uniform()),
        "kv_cache_bytes": int(rng.integers(1, 1 << 40)), "kv_occupancy": float(rng.uniform()),
        "kv_bytes_per_step": int(rng.integers(1, 1 << 36)),
        "prefix_cached_blocks": int(rng.integers(0, 64)),
        "prefix_shared_pages": int(rng.integers(0, 16)),
        "prefix_hit_blocks": 40 * sheds, "prefix_hit_tokens": 2560 * sheds,
        "prefix_cow_copies": 3 * sheds, "prefix_evicted_blocks": 5 * sheds,
        "prefix_bytes_saved": (1 << 35) * sheds,
        "prefix_cache_hits": sheds, "prefix_cache_entries": 2,
        "decode_step_times_s": rng.uniform(0, 0.05, 7).tolist(),
        "decode_dispatch_times_s": rng.exponential(0.001, 5).tolist() + [0.0005, 7.5],
        "decode_sync_times_s": rng.uniform(0, 0.02, 5).tolist(),
        "decode_host_lag_steps": [1, 2, 2, 8, 16, 40, 0],
        "decode_steps_in_flight": int(rng.integers(0, 3)),
        "ttft_s": rng.uniform(0, 2, 3).tolist() + [0.1],
        "inter_token_s": rng.uniform(0, 0.03, 9).tolist() + [0.0, 0.0],
        "spec_mode": "ngram", "spec_k": 4, "spec_accept_rate": float(rng.uniform()),
        "spec_tokens_per_forward": 1 + 4 * float(rng.uniform()),
        "spec_slot_steps_total": 10 * sheds,
        "spec_accept_rate_per_slot": rng.uniform(0, 1, 3).tolist(),
        "spec_draft_overhead_fraction": float(rng.uniform()),
        "spec_accepted_per_step": rng.integers(1, 6, 5).tolist() + [16, 17],
        "adapter_loaded": int(rng.integers(0, 7)), "adapter_evictions_total": 2 * sheds,
        "adapter_pool_bytes": 252_706_848,
        "tenant_counters": [{"tenant": t, "slo_class": c, "admitted": 3 * sheds,
                             "shed": sheds, "tokens": 40 * sheds, "queued": 1, "preempted": 0}
                            for t, c in (("", "interactive"), ("acme", "batch"))],
        "queue_by_class": {"interactive": 1, "batch": 1},
        "ttft_by_class": [("interactive", float(v)) for v in rng.uniform(0, 2, 2)]
                         + [("batch", 0.3)],
        "disaggregation": "remote_prefill", "handoffs_total": 4 * sheds,
        "handoff_transfer_bytes_total": (1 << 30) * sheds,
        "handoff_queue_depth": int(rng.integers(0, 4)),
        "handoff_network_bytes_total": (1 << 31) * sheds,
        "handoff_times_s": rng.uniform(0, 0.5, 3).tolist(),
        "fleet_ejections_total": sheds, "fleet_reinstatements_total": sheds - 1,
        "fleet_resumes_total": 3 * sheds, "fleet_resumed_tokens_total": 17 * sheds,
        "fleet_retry_budget_exhausted_total": 2 * sheds,
        "fleet_resume_journal_depth": int(rng.integers(0, 4)),
    }


class _Stub:
    def __init__(self):
        self.snapshots = []

    def llm_stats(self):
        return self.snapshots.pop(0)


def test_registry_text_equals_jax():
    port, ref, stub = MetricsRegistry(), JaxRegistry(), _Stub()
    calls = [("predict", "200", 0.003), ("generate", "200", 0.42), ("generate", "400", 0.0005),
             ("predict", "200", 2.5), ("generate", "503", 12.0)]
    for reg in (port, ref):
        for call in calls:
            reg.observe_api_call(*call)
    for seed, sheds in ((0, 1), (1, 3), (2, 2)):  # a tally never counts down
        for reg in (port, ref):
            stub.snapshots.append(stats(seed, sheds))
            reg.sync_llm(stub)
    got = families(port.expose().decode())
    want = families(ref.expose().decode())
    assert set(got) == PORT_FAMILIES
    for name, fam in got.items():
        assert (fam.type, fam.documentation, fam.samples) == \
            (want[name].type, want[name].documentation, want[name].samples), name
    assert got["seldon_llm_kv_page_sheds"].samples[0].value == 3


def test_empty_registry_equals_jax():
    got, want = families(MetricsRegistry().expose().decode()), families(
        JaxRegistry().expose().decode())
    for name, fam in got.items():
        assert (fam.type, fam.documentation, fam.samples) == \
            (want[name].type, want[name].documentation, want[name].samples), name


def jax_threaded_app(comp):
    app = jax_app(comp)
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app)
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        run.port = s.getsockname()[1]
        loop.run_until_complete(web.SockSite(runner, s).start())
        started.set()
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    assert started.wait(10)
    return run.port, lambda: loop.call_soon_threadsafe(loop.stop)


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=TIMEOUT) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def post(port, body, path="/v1/generate"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(scope="module")
def apps():
    """(JAX app port, port app port, port server): the JAX LLMServer and its
    port twin (the same weights), each behind its component app."""
    j = JaxLLMServer(init_random=True, **COMMON)
    j.load()
    jport, jstop = jax_threaded_app(j)
    p = LLMServer(device="cpu", **COMMON)
    p.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    httpd, _ = start(make_component_app(p, device="cpu"))
    try:
        yield jport, httpd.server_address[1], p
    finally:
        jstop()
        httpd.shutdown()
        httpd.server_close()
        if getattr(p, "_batcher_service", None) is not None:
            p._batcher_service.close()


REQUESTS = [({"prompt": "hello"}, "/v1/generate"),
            ({"prompt": [5, 9, 2], "stream": True}, "/v1/generate"),
            ({"prompt": "hi", "temperature": 0.5, "stream": True}, "/v1/generate"),
            ({"nothing": 1}, "/v1/generate"),
            ({"jsonData": {"prompt": "hi"}}, "/predict"),
            ({"jsonData": {}}, "/api/v0.1/predictions")]


def test_request_series_equal_jax_app(apps):
    jport, pport, _ = apps
    for port in (jport, pport):
        codes = [post(port, body, path)[0] for body, path in REQUESTS]
        assert codes == [200, 200, 400, 400, 200, 400], port
    got = families(get(pport, "/metrics")[2])
    want = families(get(jport, "/metrics")[2])
    for name in ("seldon_api_executor_server_requests",):
        assert got[name].samples == want[name].samples
    counts = [[s for s in fams["seldon_api_executor_server_requests_seconds"].samples
               if s.name.endswith("_count")] for fams in (got, want)]
    assert counts[0] == counts[1]


def test_live_scrape_counts_the_streams(apps):
    _, pport, server = apps
    before = families(get(pport, "/metrics")[2])  # drains what earlier tests left
    bodies = [{"prompt": "hello world", "stream": True},
              {"prompt": [7, 7, 1, 2], "max_new_tokens": 9, "stream": True},
              {"prompt": "abc", "max_new_tokens": 4}]
    results = [None] * len(bodies)

    def client(i):
        results[i] = post(pport, bodies[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert all(r is not None and r[0] == 200 for r in results)
    credited = sum(b.get("max_new_tokens", COMMON["max_new_tokens"]) for b in bodies)
    code, ctype, text = get(pport, "/metrics")
    assert code == 200 and ctype.startswith("text/plain")
    fams = families(text)

    def value(name, suffix="", scrape=None):
        return next(s.value for s in (scrape or fams)[name].samples if s.name == name + suffix)

    def added(name):  # histograms are cumulative: this run's observations
        return value(name, "_count") - value(name, "_count", before)

    assert added("seldon_llm_ttft_seconds") == len(bodies)
    assert added("seldon_llm_inter_token_seconds") == credited - len(bodies)
    pages = server._batcher_service.batcher.page_stats()
    assert value("seldon_llm_kv_pages_in_use") == pages["kv_pages_in_use"] == 0
    assert value("seldon_llm_kv_pages_total") == pages["kv_pages_total"]
    assert value("seldon_llm_kv_page_sheds", "_total") == pages["kv_page_sheds"]
    assert added("seldon_llm_decode_dispatch_seconds") > 0
    # llm_stats drained the series: another scrape adds no observation
    stats_now = server.llm_stats()
    assert stats_now["ttft_s"] == [] and stats_now["inter_token_s"] == []
    again = families(get(pport, "/prometheus")[2])
    for name in ("seldon_llm_ttft_seconds", "seldon_llm_inter_token_seconds",
                 "seldon_llm_decode_step_seconds"):
        assert again[name].samples == fams[name].samples


def test_seldon_json_is_the_wrapper_spec(apps):
    jport, pport, _ = apps
    code, ctype, text = get(pport, "/seldon.json")
    assert code == 200 and ctype == "application/json"
    assert json.loads(text) == jax_wrapper_spec() == json.loads(get(jport, "/seldon.json")[2])


def test_llm_stats_spec_fields(apps):
    """Speculation off: the spec fields are zeros. On (the n-gram batcher
    behind the component app): one request's verify steps reach the
    scrape, and llm_stats drains the accepted-tokens series."""
    _, _, server = apps
    off = server.llm_stats()
    assert off["spec_mode"] == "off" and off["spec_k"] == 0
    assert (off["spec_accept_rate"], off["spec_tokens_per_forward"],
            off["spec_slot_steps_total"], off["spec_accept_rate_per_slot"],
            off["spec_draft_overhead_fraction"], off["spec_accepted_per_step"]) == \
        (0.0, 0.0, 0, [], 0.0, [])
    j = JaxLLMServer(init_random=True, **COMMON)
    j.load()
    p = LLMServer(device="cpu", spec_mode="ngram", spec_k=4, **COMMON)
    p.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    httpd, _ = start(make_component_app(p, device="cpu"))
    port = httpd.server_address[1]
    try:
        code, body = post(port, {"prompt": "abcabcabcabc"})
        assert code == 200
        assert json.loads(body)["tokens"] == j.generate(["abcabcabcabc"])["tokens"][0]
        fams = families(get(port, "/metrics")[2])
        steps = p._batcher_service.batcher.spec_stats()["spec_slot_steps_total"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        p._batcher_service.close()
    assert steps > 0
    value = {s.name: s.value for fam in fams.values() for s in fam.samples
             if not s.labels.get("slot") and not s.labels.get("le")}
    assert value["seldon_llm_spec_slot_verify_steps_total"] == steps
    assert value["seldon_llm_spec_accepted_tokens_per_step_count"] == steps
    assert value["seldon_llm_spec_tokens_per_forward"] >= 1.0
    assert len([s for s in fams["seldon_llm_spec_accept_rate_per_slot"].samples]) == 2
    assert p.llm_stats()["spec_accepted_per_step"] == []


def test_live_scrape_prefix_series():
    """A chat through the radix batcher behind the component app: turn 2
    hits turn 1's blocks (one CoW copy), and one scrape's prefix and KV
    gauges and counters equal ``llm_stats`` after it (lifetime counters,
    no traffic between), as the JAX registry renders that snapshot."""
    j = JaxLLMServer(init_random=True, **COMMON)
    j.load()
    knobs = dict(prefix_cache_size=4, kv_page_size=4, prefill_chunk=8)
    p = LLMServer(device="cpu", **dict(COMMON, **knobs))
    p.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    httpd, _ = start(make_component_app(p, device="cpu"))
    port = httpd.server_address[1]
    try:
        turn1 = [9, 8, 7, 6, 5, 4, 3, 2, 1, 11]
        code, body = post(port, {"prompt": turn1})
        assert code == 200
        code, _ = post(port, {"prompt": turn1 + json.loads(body)["tokens"] + [30, 31]})
        assert code == 200
        fams = families(get(port, "/metrics")[2])
        stats = p.llm_stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        p._batcher_service.close()
    value = {s.name: s.value for fam in fams.values() for s in fam.samples}
    assert stats["prefix_hit_blocks"] > 0 and stats["prefix_cow_copies"] == 1
    assert stats["kv_pages_in_use"] == stats["prefix_cached_blocks"] > 0
    for key, name in (("prefix_hit_blocks", "seldon_llm_prefix_hit_blocks_total"),
                      ("prefix_shared_pages", "seldon_llm_prefix_shared_pages"),
                      ("prefix_cached_blocks", "seldon_llm_prefix_cached_blocks"),
                      ("prefix_cow_copies", "seldon_llm_prefix_cow_copies_total"),
                      ("prefix_evicted_blocks", "seldon_llm_prefix_evicted_blocks_total"),
                      ("prefix_bytes_saved", "seldon_llm_prefix_bytes_saved_total"),
                      ("kv_cache_bytes", "seldon_llm_kv_cache_bytes"),
                      ("kv_occupancy", "seldon_llm_kv_cache_occupancy"),
                      ("kv_bytes_per_step", "seldon_llm_kv_bytes_per_step"),
                      ("kv_page_fragmentation", "seldon_llm_kv_page_fragmentation")):
        assert value[name] == stats[key], name
    assert stats["kv_cache_bytes"] == stats["kv_bytes_per_step"] == \
        p._batcher_service.batcher._cache_nbytes
    ref, stub = JaxRegistry(), _Stub()
    stub.snapshots.append(dict(stats))
    ref.sync_llm(stub)
    want = families(ref.expose().decode())
    for name in PORT_FAMILIES:
        if name.startswith(("seldon_llm_prefix", "seldon_llm_kv")):
            assert fams[name].samples == want[name].samples, name


def test_engine_series_equal_jax():
    """The engine app's series fed the same observations: predictions with
    in-band custom metrics (counters with and without tags, a key ending
    in _total, gauges, millisecond timers; a key under a second tag set
    raises on both), feedback with rewards of both
    signs, deadline expiries and remaining budgets, and scrape-time syncs
    of breakers (transitions wired on first sight, rejections caught up)
    and admission. Every family the port emits equals the JAX registry's."""
    from seldon_core_tpu.contracts.payload import Feedback as JaxFeedback
    from seldon_core_tpu.contracts.payload import SeldonMessage as JaxMessage
    from seldon_core_tpu.runtime.resilience import CircuitBreaker as JaxBreaker
    from seldon_core_tpu_torch.contracts.payload import Feedback, SeldonMessage
    from seldon_core_tpu_torch.runtime.resilience import CircuitBreaker

    metrics = [{"key": "mycounter", "type": "COUNTER", "value": 1.0},
               {"key": "hits_total", "type": "COUNTER", "value": 2.5},
               {"key": "tagged", "type": "COUNTER", "value": 3.0,
                "tags": {"model": "a", "zone": "z"}},
               {"key": "mygauge", "type": "GAUGE", "value": 100.0},
               {"key": "mytimer", "type": "TIMER", "value": 20.6},
               {"key": "slow", "type": "TIMER", "value": 7300.0, "tags": {"model": "b"}}]
    clock = [0.0]

    class Stub:
        def __init__(self, breakers):
            self._breakers = breakers

        def breakers(self):
            return self._breakers

    class Admission:
        inflight, shed_total = 2, 5

        def queue_depth(self):
            return 1

    sides = []
    for reg, msg, fb, breaker in ((MetricsRegistry(), SeldonMessage, Feedback, CircuitBreaker),
                                  (JaxRegistry(), JaxMessage, JaxFeedback, JaxBreaker)):
        engine = Stub([(n, breaker(n, failure_threshold=2, reset_timeout_s=5.0,
                                   clock=lambda: clock[0])) for n in ("a", "b")])
        for i in range(3):
            reg.observe_prediction(engine, msg.from_dict({"meta": {"metrics": metrics[i:]}}),
                                   0.002 * (i + 1))
        for reward in (1.0, 0.0, -0.5, 0.25):
            reg.observe_feedback(fb.from_dict({"reward": reward}))
        for transport in ("rest", "grpc", "rest"):
            reg.observe_deadline_exceeded(transport)
        for s in (0.3, -1.0, 2.0):
            reg.observe_remaining_budget(s)
        reg.sync_resilience(engine=engine, admission=Admission(), transport="rest")
        b = engine.breakers()[0][1]
        b.record_failure()
        b.record_failure()  # open
        assert not b.allow() and not b.allow()  # two rejections
        reg.sync_resilience(engine=engine, admission=Admission(), transport="grpc")
        sides.append(families(reg.expose().decode()))
        # one key under a second tag set is a second family of one name,
        # which prometheus_client refuses
        with pytest.raises(ValueError, match="Duplicated timeseries"):
            reg.register_custom(msg.from_dict({"meta": {"metrics": [
                {"key": "mycounter", "type": "COUNTER", "value": 1.0, "tags": {"k": "v"}}]}}))
    got, want = sides
    assert {"mycounter", "hits", "tagged", "mygauge", "mytimer", "slow"} <= set(got)
    for name, fam in got.items():
        assert (fam.type, fam.documentation, fam.samples) == \
            (want[name].type, want[name].documentation, want[name].samples), name
    assert got["seldon_resilience_breaker_rejected"].samples[0].value == 2
