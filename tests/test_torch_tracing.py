"""The port's tracer (``seldon_core_tpu_torch/tracing/``) held against the
JAX package's (``seldon_core_tpu/tracing``) on the same inputs, on the CPU:

- ``_parse_traceparent`` over every header of JAX ``tests/test_tracing.py``
  (valid, unsampled, a future version's extra field, a version-00 fifth
  field, the malformed ones): equal results, and equal ``TraceContext``s;
- an unsampled span is not recorded but its flag propagates; a sampled one
  is recorded under the caller's span;
- the anchored span clock: a backward or forward wall step mid-span leaves
  the duration as the monotonic clock says, in both packages;
- export failure accounting: the single re-enqueue, the drop count, the
  buffer bound, and no inline flush with an exporter installed, in both
  packages on the same script;
- ``spans_to_otlp`` gives JAX's dict for the same spans; ``OTLPExporter``
  posts it to a local ``http.server`` (a 500 is a failed export);
  ``install_from_env``; ``tail_thresholds``; ``get_tracer`` from the
  environment;
- ``sync_tracing``: the three families' text equals the JAX registry's;
- propagation: a REST ``traceparent`` -> the engine app's server span ->
  the node span -> the remote hop's outbound header; a hop run on the
  fleet's dispatch pool keeps the caller's span; a hop outside any span
  sends no header; gRPC metadata round-trips (unsampled: not recorded)."""

import json
import threading
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

import seldon_core_tpu.tracing as jtracing
import seldon_core_tpu_torch.tracing as tracing
from seldon_core_tpu.metrics.registry import MetricsRegistry as JaxRegistry
from seldon_core_tpu.tracing import export as jexport
from seldon_core_tpu_torch.metrics.registry import MetricsRegistry
from seldon_core_tpu_torch.testing.faults import FaultClock
from seldon_core_tpu_torch.tracing import (Span, TraceContext, Tracer, _parse_traceparent,
                                           current_traceparent, get_tracer, set_tracer,
                                           tail_thresholds)
from seldon_core_tpu_torch.tracing import export

TRACE_ID = "ab" * 16
SPAN_ID = "cd" * 8
VALID_TP = f"00-{TRACE_ID}-{SPAN_ID}-01"
UNSAMPLED_TP = f"00-{TRACE_ID}-{SPAN_ID}-00"
TIMEOUT = 30

# every header of JAX tests/test_tracing.py:48-96
HEADERS = [
    VALID_TP,
    UNSAMPLED_TP,
    f"01-{TRACE_ID}-{SPAN_ID}-01-extrastate",
    f"00-{TRACE_ID}-{SPAN_ID}-01-extra",
    None,
    "",
    "garbage",
    "00-abc-def-01",
    f"00-{TRACE_ID}-{SPAN_ID}",
    f"zz-{TRACE_ID}-{SPAN_ID}-01",
    f"ff-{TRACE_ID}-{SPAN_ID}-01",
    f"00-{'xy' * 16}-{SPAN_ID}-01",
    f"00-{'0' * 32}-{SPAN_ID}-01",
    f"00-{TRACE_ID}-{'0' * 16}-01",
    f"00-{TRACE_ID[:-2]}-{SPAN_ID}-01",
    f"00-{TRACE_ID}-{SPAN_ID}ab-01",
    f"00-+{TRACE_ID[:-1]}-{SPAN_ID}-01",
    f"00-{TRACE_ID}-{SPAN_ID}- 1",
    f"00- {TRACE_ID[:-1]}-{SPAN_ID}-01",
    "totally-not-a-traceparent",
]


@pytest.fixture()
def fresh_tracer():
    old = get_tracer()
    t = Tracer(enabled=True)
    set_tracer(t)
    yield t
    set_tracer(old)


@pytest.fixture()
def anchored():
    """Both packages' span clocks given back their real sources after."""
    yield
    tracing.anchor()
    jtracing.anchor()


# ------------------------------------------------------------------ parser
@pytest.mark.parametrize("header", HEADERS, ids=[repr(h)[:40] for h in HEADERS])
def test_parse_traceparent_equals_jax(header):
    want = jtracing._parse_traceparent(header)
    assert _parse_traceparent(header) == want
    got = TraceContext.from_traceparent(header, ingress="rest:/v1/generate")
    ref = jtracing.TraceContext.from_traceparent(header, ingress="rest:/v1/generate")
    assert (got.parent_span_id, got.sampled, got.ingress) == \
        (ref.parent_span_id, ref.sampled, ref.ingress)
    if want is None:  # a fresh trace of its own on each side
        assert len(got.trace_id) == 32 and got.trace_id != TRACE_ID and got.sampled
    else:
        assert got.trace_id == ref.trace_id == want[0]


def test_unsampled_span_not_recorded_and_flag_propagates(fresh_tracer):
    with fresh_tracer.span("op", traceparent=UNSAMPLED_TP) as s:
        assert s.sampled is False and s.traceparent().endswith("-00")
        assert current_traceparent() == s.traceparent()
        with fresh_tracer.span("child") as c:
            assert c.sampled is False and c.parent_id == s.span_id
    assert fresh_tracer.drain() == []
    assert current_traceparent() is None
    with fresh_tracer.span("op", traceparent=VALID_TP) as s:
        assert s.traceparent().endswith("-01")
    spans = fresh_tracer.drain()
    assert [(x.name, x.trace_id, x.parent_id) for x in spans] == [("op", TRACE_ID, SPAN_ID)]


def test_disabled_tracer_yields_none():
    t = Tracer(enabled=False)
    with t.span("op", traceparent=VALID_TP) as s:
        assert s is None and current_traceparent() is None
    assert t.drain() == []


# ------------------------------------------------------------------- clock
@pytest.mark.parametrize("step", [-3600.0, 10_000.0], ids=["backward", "forward"])
def test_span_clock_survives_wall_step(anchored, step):
    got = []
    for mod in (tracing, jtracing):
        clock = FaultClock(start=100.0)
        wall = {"t": 5_000.0}
        mod.anchor(wall=lambda: wall["t"], mono=clock)
        clock.advance(2.0)
        tr = mod.Tracer(enabled=True)
        with tr.span("op") as s:
            wall["t"] += step
            clock.advance(0.25)
        got.append((s.start, s.end, s.to_dict()["durationUs"]))
    assert got[0] == got[1] == (5_002.0, 5_002.25, 250_000)


def test_recorder_tracks_clock_reanchor(anchored):
    """A tracing.anchor() correction reaches the flight recorder's spans."""
    from seldon_core_tpu_torch.runtime.flight import EV_FIRST_TOKEN, FlightRecorder

    mono = FaultClock(start=10.0)
    wall = {"t": 1_000.0}
    tracing.anchor(wall=lambda: wall["t"], mono=mono)
    fr = FlightRecorder(1)
    tr = Tracer(enabled=True)
    wall["t"] = 50_000.0
    tracing.anchor(wall=lambda: wall["t"], mono=mono)
    fr.begin(0, None, None, prompt_tokens=1)
    fr.record(0, EV_FIRST_TOKEN, tokens=1)
    fr.complete(0, "done", 1, tr)
    root = [s for s in tr.drain() if s.parent_id is None][0]
    assert root.start >= 49_000.0


# ------------------------------------------------------------ export faults
def _failing_exporter(fail_times):
    calls = []

    def exporter(spans):
        calls.append([s.name for s in spans])
        if len(calls) <= fail_times:
            raise RuntimeError("collector down")

    exporter.calls = calls
    return exporter


def _script(mod, scenario):
    """One export-failure scenario on ``mod``'s tracer: (exporter calls,
    spans dropped, buffer left, export walls observed)."""
    if scenario == "blip":
        tr = mod.Tracer(enabled=True)
        tr.exporter = _failing_exporter(1)
        with tr.span("a"):
            pass
        tr.flush()
        assert tr.spans_dropped_total == 0
        tr.flush()
    elif scenario == "second_failure":
        tr = mod.Tracer(enabled=True)
        tr.exporter = _failing_exporter(10)
        with tr.span("a"):
            pass
        tr.flush()
        tr.flush()
        tr.flush()  # nothing left: nothing exported, nothing counted
    elif scenario == "reenqueue_bound":
        tr = mod.Tracer(enabled=True, max_buffer=2)
        tr.exporter = _failing_exporter(10)
        tr.record_spans([mod.Span(name=f"s{i}", trace_id=TRACE_ID, span_id=f"{i:016x}",
                                  parent_id=None) for i in range(3)])
        tr.flush()  # fails: the buffer's two re-enqueue, the third was dropped
    else:  # "full_buffer": with an exporter the recording thread never flushes
        tr = mod.Tracer(enabled=True, max_buffer=2)
        tr.exporter = _failing_exporter(10)
        for name in ("a", "b"):
            with tr.span(name):
                pass
        tr.record_spans([mod.Span(name=f"x{i}", trace_id=TRACE_ID, span_id=f"{i:016x}",
                                  parent_id=None) for i in range(3)])
        with tr.span("c"):
            pass
        assert tr.exporter.calls == []
        tr.flush()
        tr.flush()
    stats = tr.export_stats()
    return (tr.exporter.calls, stats["spans_dropped_total"], [s.name for s in tr.drain()],
            len(stats["export_times_s"]))


@pytest.mark.parametrize("scenario", ["blip", "second_failure", "reenqueue_bound",
                                      "full_buffer"])
def test_export_failure_accounting_equals_jax(scenario):
    got, want = _script(tracing, scenario), _script(jtracing, scenario)
    assert got == want
    expected_dropped = {"blip": 0, "second_failure": 1, "reenqueue_bound": 1, "full_buffer": 6}
    assert got[1] == expected_dropped[scenario]


# -------------------------------------------------------------------- OTLP
def _spans(mod):
    return [mod.Span(name="llm.request rest:/v1/generate", trace_id=TRACE_ID, span_id=SPAN_ID,
                     parent_id=None, start=1_700_000_000.123456, end=1_700_000_000.5,
                     tags={"slot": 3, "status": "done", "ttft_ms": 12.5, "ok": True,
                           "sampling": "head"}),
            mod.Span(name="llm.step", trace_id=TRACE_ID, span_id="ef" * 8, parent_id=SPAN_ID,
                     start=1_700_000_000.2, end=None, tags={"tokens": 1}),
            mod.Span(name="llm.page_grow", trace_id=TRACE_ID, span_id="12" * 8,
                     parent_id=SPAN_ID, start=1_700_000_000.3, end=1_700_000_000.25,
                     tags={"pages": 1, "why": None})]


def test_spans_to_otlp_equals_jax():
    got = export.spans_to_otlp(_spans(tracing), "svc")
    assert got == jexport.spans_to_otlp(_spans(jtracing), "svc")
    spans = got["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert [s.get("parentSpanId") for s in spans] == [None, SPAN_ID, SPAN_ID]
    assert spans[2]["endTimeUnixNano"] == spans[2]["startTimeUnixNano"]  # end clamped


class _Collector:
    """An OTLP/HTTP collector on 127.0.0.1: each POST body kept; answers
    ``status`` (200 unless set)."""

    def __init__(self):
        self.bodies, self.paths, self.status = [], [], 200
        outer = self

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers["Content-Length"])
                outer.paths.append(self.path)
                outer.bodies.append(json.loads(self.rfile.read(n)))
                self.send_response(outer.status)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_otlp_exporter_posts_to_a_collector():
    col = _Collector()
    try:
        tr = Tracer(enabled=True, service_name="svc")
        tr.exporter = export.OTLPExporter(col.url + "/", service_name="svc", timeout_s=TIMEOUT)
        tr.record_spans(_spans(tracing))
        tr.flush()
        assert col.paths == ["/v1/traces"]
        assert col.bodies == [export.spans_to_otlp(_spans(tracing), "svc")]
        col.status = 500  # a failed export: re-enqueued once, then dropped
        tr.record_spans(_spans(tracing)[:1])
        tr.flush()
        assert tr.spans_dropped_total == 0 and len(tr._buffer) == 1
        tr.flush()
        assert tr.spans_dropped_total == 1 and tr._buffer == []
        assert len(tr.export_stats()["export_times_s"]) == 3
    finally:
        col.close()
    with pytest.raises(urllib.error.URLError):  # nothing listens there now
        export.OTLPExporter(col.url, timeout_s=TIMEOUT)(_spans(tracing))


def test_install_from_env():
    assert export.install_from_env(Tracer(enabled=True), env={}) is None
    assert export.install_from_env(Tracer(enabled=False),
                                   env={"OTEL_EXPORTER_OTLP_ENDPOINT": "http://h:4318"}) is None
    col = _Collector()
    try:
        for key in ("OTEL_EXPORTER_OTLP_ENDPOINT", "TRACING_OTLP_ENDPOINT"):
            tr = Tracer(enabled=True, service_name="svc")
            flusher = export.install_from_env(tr, env={key: col.url})
            assert isinstance(tr.exporter, export.OTLPExporter)
            assert tr.exporter.url == col.url + "/v1/traces"
            with tr.span("op"):
                pass
            flusher.stop()  # the final flush ships what the buffer holds
            assert not flusher._thread.is_alive()
        assert [[s["name"] for s in b["resourceSpans"][0]["scopeSpans"][0]["spans"]]
                for b in col.bodies] == [["op"], ["op"]]
    finally:
        col.close()


def test_get_tracer_from_environment(monkeypatch):
    old = get_tracer()
    try:
        monkeypatch.setenv("TRACING", "1")
        monkeypatch.setenv("JAEGER_SERVICE_NAME", "my-llm")
        monkeypatch.delenv("OTEL_EXPORTER_OTLP_ENDPOINT", raising=False)
        monkeypatch.delenv("TRACING_OTLP_ENDPOINT", raising=False)
        set_tracer(None)
        t = get_tracer()
        assert (t.enabled, t.service_name, t.exporter) == (True, "my-llm", None)
        assert get_tracer() is t
        monkeypatch.setenv("TRACING", "0")
        set_tracer(None)
        assert get_tracer().enabled is False
    finally:
        set_tracer(old)


@pytest.mark.parametrize("env", [{}, {"TRACING_TAIL_TTFT_MS": "250"},
                                 {"TRACING_TAIL_GAP_MS": "50"},
                                 {"TRACING_TAIL_TTFT_MS": "garbage", "TRACING_TAIL_GAP_MS": "-1"},
                                 {"TRACING_TAIL_TTFT_MS": "0", "TRACING_TAIL_GAP_MS": "12.5"}])
def test_tail_thresholds_equal_jax(env):
    assert tail_thresholds(env) == jtracing.tail_thresholds(env)


# ----------------------------------------------------------------- scrape
def test_sync_tracing_families_equal_jax():
    def families(text):
        return {f.name: f for f in text_string_to_metric_families(text)
                if f.name.startswith(("seldon_trace", "seldon_llm_traces"))}

    regs = []
    for mod, reg in ((tracing, MetricsRegistry("d", "p")), (jtracing, JaxRegistry("d", "p"))):
        tr = mod.Tracer(enabled=True)
        tr.exporter = _failing_exporter(10)
        with tr.span("a"):
            pass
        tr.flush()
        tr.flush()
        for mode in ("tail", "head", "head"):
            tr.count_retained(mode)
        reg.sync_tracing(tr)
        reg.sync_tracing(tr)  # catch-up: a second sync adds nothing
        regs.append(families(reg.expose().decode()))
    got, want = regs
    assert set(got) == {"seldon_trace_spans_dropped", "seldon_trace_export_seconds",
                        "seldon_llm_traces_retained"}
    for name, fam in got.items():
        hist = fam.type == "histogram"
        # the export walls are this run's: compare a histogram by its count
        strip = (lambda ss: [(s.name, s.labels) for s in ss]) if hist else (lambda ss: ss)
        assert (fam.type, fam.documentation, strip(fam.samples)) == \
            (want[name].type, want[name].documentation, strip(want[name].samples)), name
    value = {(s.name, s.labels.get("mode")): s.value for f in got.values() for s in f.samples}
    assert value[("seldon_trace_spans_dropped_total", None)] == 1
    assert value[("seldon_trace_export_seconds_count", None)] == 2
    assert value[("seldon_llm_traces_retained_total", "head")] == 2


# ------------------------------------------------------------- propagation
class _Hop:
    """A downstream service on 127.0.0.1 recording each request's
    ``traceparent`` and echoing its JSON body."""

    def __init__(self):
        self.seen = []
        outer = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self):
                outer.seen.append(self.headers.get("traceparent"))
                body = self.rfile.read(int(self.headers["Content-Length"]))
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.port = self.httpd.server_address[1]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_rest_header_to_engine_nodes_to_remote_hop(fresh_tracer):
    import urllib.request

    from seldon_core_tpu_torch.contracts.graph import PredictorSpec
    from seldon_core_tpu_torch.runtime.engine import GraphEngine
    from seldon_core_tpu_torch.transport.rest import make_engine_app, start

    hop = _Hop()
    spec = PredictorSpec.from_dict({"name": "p", "graph": {
        "name": "m", "type": "MODEL",
        "endpoint": {"service_host": "127.0.0.1", "service_port": hop.port, "type": "REST"}}})
    engine = GraphEngine(spec, device="cpu")
    httpd, _ = start(make_engine_app(engine, device="cpu"))
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/api/v0.1/predictions",
            data=json.dumps({"data": {"ndarray": [[1.0]]}}).encode(),
            headers={"Content-Type": "application/json", "traceparent": VALID_TP})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            assert r.status == 200
    finally:
        httpd.shutdown()
        httpd.server_close()
        hop.close()
    spans = {s.name: s for s in fresh_tracer.drain()}
    assert set(spans) == {"predictions", "node:m"}
    assert all(s.trace_id == TRACE_ID for s in spans.values())
    assert spans["predictions"].parent_id == SPAN_ID
    assert spans["node:m"].parent_id == spans["predictions"].span_id
    assert hop.seen == [f"00-{TRACE_ID}-{spans['node:m'].span_id}-01"]


def test_hop_on_the_fleet_dispatch_pool_keeps_the_span(fresh_tracer):
    """A pool thread starts with an empty context: the fleet's dispatch runs
    in a copy of the caller's, so a hop made there carries its span."""
    from seldon_core_tpu_torch.runtime.engine import ReplicaSet

    seen = []

    class Allocator:
        def stats(self):
            return (10, 0, 0)

    class Batcher:  # what the fleet reads of a replica's batcher
        _pending, _slots, _allocator = [], [], Allocator()
        crashed, _thread, heartbeat = None, None, 0.0

    class Svc:
        batcher = Batcher()

        def submit_sync(self, prompt, max_new_tokens=None, on_token=None, **kw):
            seen.append((current_traceparent(), threading.current_thread().name, kw.get("trace")))
            return [1, 2]

    class Replica:
        def __init__(self):
            self._batcher_service = Svc()

    rs = ReplicaSet([Replica()])
    ctx = TraceContext(trace_id=TRACE_ID, parent_span_id=SPAN_ID)
    with fresh_tracer.span("rest:/v1/generate", traceparent=VALID_TP) as s:
        assert rs.submit([5, 6], 2, trace=ctx).result(TIMEOUT) == [1, 2]
    assert rs.submit([5, 6], 2).result(TIMEOUT) == [1, 2]  # outside any span
    assert seen[0] == (s.traceparent(), seen[0][1], ctx)
    assert seen[0][1].startswith("fleet-dispatch")
    assert seen[1][0] is None and seen[1][2] is None


def test_remote_hop_without_span_sends_no_header(fresh_tracer):
    import asyncio

    from seldon_core_tpu_torch.contracts.graph import Endpoint
    from seldon_core_tpu_torch.contracts.payload import SeldonMessage
    from seldon_core_tpu_torch.runtime.remote import RemoteComponent

    hop = _Hop()
    comp = RemoteComponent(Endpoint(service_host="127.0.0.1", service_port=hop.port,
                                    type="REST"))
    try:
        msg = SeldonMessage.from_dict({"data": {"ndarray": [[1.0]]}})
        asyncio.run(comp.predict_raw(msg))
        with fresh_tracer.span("node:x", traceparent=UNSAMPLED_TP) as s:
            asyncio.run(comp.predict_raw(msg))
    finally:
        comp.close()
        hop.close()
    assert hop.seen == [None, s.traceparent()]
    assert hop.seen[1].endswith("-00")  # the unsampled flag rides on


class _Echo:
    def predict(self, X, names, meta=None):
        return np.asarray(X)


@pytest.mark.parametrize("tp,recorded", [(VALID_TP, True), (UNSAMPLED_TP, False)],
                         ids=["sampled", "unsampled"])
def test_grpc_metadata_traceparent_roundtrip(fresh_tracer, tp, recorded):
    from seldon_core_tpu_torch.contracts.payload import SeldonMessage
    from seldon_core_tpu_torch.transport.grpc_client import call_sync
    from seldon_core_tpu_torch.transport.grpc_server import make_component_server

    server = make_component_server(_Echo(), port=None)
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    try:
        out = call_sync(f"127.0.0.1:{port}", "Predict",
                        SeldonMessage.from_dict({"data": {"ndarray": [[1.0, 2.0]]}}),
                        timeout_s=TIMEOUT, metadata=[("traceparent", tp)])
        assert out.to_dict()["data"]["ndarray"] == [[1.0, 2.0]]
    finally:
        server.stop(None)
    spans = fresh_tracer.drain()
    if not recorded:
        assert spans == []
        return
    assert [(s.name, s.trace_id, s.parent_id) for s in spans] == [
        ("grpc:predict", TRACE_ID, SPAN_ID)]
