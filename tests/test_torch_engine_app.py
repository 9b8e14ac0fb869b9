"""The port's engine app (``seldon_core_tpu_torch/transport/rest.py``
``make_engine_app``, the stdlib ``ThreadingHTTPServer``) beside the JAX
package's (aiohttp, run on a thread of its own), each over its own
``GraphEngine`` of the same spec, on the CPU:

- predictions (tensor and ndarray bodies, ``/api/v0.1/predictions`` and
  ``/predict``) through a seeded EPSILON_GREEDY router over a SIMPLE_MODEL
  and a fused AVERAGE_COMBINER, then feedback (``/api/v0.1/feedback`` and
  ``/send-feedback``): the same status codes and bodies; then one scrape
  of each: the request, feedback and resilience series and the in-band
  custom metrics (SIMPLE_MODEL's; the router's stay in its route answer,
  whose tags reach the response) equal, latency histograms by count;
- malformed JSON 400, pause / unpause / ready, an admission shed 503 with
  its ``Retry-After``, a spent ``Seldon-Deadline-Ms`` 504 (and the deadline
  counter), ``/live``, ``/ping``, ``/seldon.json`` and a disabled
  ``/profile``: the same status codes and bodies (for the 504, its code,
  reason and status: its message carries the overrun in ms);
- the port alone: an enabled ``/profile`` writes a ``torch.profiler``
  trace, ``/debug/timeline`` (``?n=``) answers 200 with the JAX engine
  app's payload (each component's report by name), the
  request and response pair is printed and POSTed to
  ``REQUEST_LOGGER_URL`` as a CloudEvent, and ``make_engine_app`` refuses
  the CPU unasked;
- the gRPC engine servers side by side (the JAX package's client):
  ``Seldon/Predict`` and ``Seldon/SendFeedback`` replies, a non-numeric
  payload's INTERNAL and a spent ``seldon-deadline-ms``'s DEADLINE_EXCEEDED."""

import asyncio
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch
from aiohttp import web
from prometheus_client.parser import text_string_to_metric_families

import grpc
import jax  # noqa: F401

from seldon_core_tpu.components.component import SeldonComponent as JaxComponent
from seldon_core_tpu.contracts.graph import PredictorSpec as JaxSpec
from seldon_core_tpu.contracts.payload import Feedback as JaxFeedback
from seldon_core_tpu.contracts.payload import SeldonMessage as JaxMessage
from seldon_core_tpu.runtime.engine import GraphEngine as JaxEngine
from seldon_core_tpu.runtime.resilience import AdmissionController as JaxAdmission
from seldon_core_tpu.transport import grpc_client
from seldon_core_tpu.transport.grpc_server import make_engine_server as jax_engine_server
from seldon_core_tpu.transport.rest import make_engine_app as jax_engine_app
from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.graph import PredictorSpec
from seldon_core_tpu_torch.runtime.engine import GraphEngine
from seldon_core_tpu_torch.runtime.resilience import AdmissionController
from seldon_core_tpu_torch.transport.grpc_server import make_engine_server
from seldon_core_tpu_torch.transport.rest import make_engine_app, start

TIMEOUT = 60
SIMPLE = {"type": "MODEL", "implementation": "SIMPLE_MODEL"}
GRAPH = {"name": "router", "type": "ROUTER", "implementation": "EPSILON_GREEDY",
         "parameters": [{"name": "epsilon", "value": "0.5", "type": "FLOAT"},
                        {"name": "seed", "value": "3", "type": "INT"}],
         "children": [dict(SIMPLE, name="a"),
                      {"name": "avg", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
                       "children": [dict(SIMPLE, name="m1"), dict(SIMPLE, name="m2")]}]}
SLOW_CHAIN = {"name": "t", "type": "TRANSFORMER", "children": [dict(SIMPLE, name="m")]}


def jax_threaded_app(app):
    """Serve an aiohttp app on a thread of its own; (port, stop)."""
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app)
    started = threading.Event()
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(web.SockSite(runner, sock).start())
        started.set()
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    assert started.wait(10)
    return sock.getsockname()[1], lambda: loop.call_soon_threadsafe(loop.stop)


def request(port, path, body=None, headers=None, method=None, raw=None):
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def slow(base):
    class Slow(base):
        def transform_input(self, X, names, meta=None):
            time.sleep(0.05)
            return X

    return {"t": Slow()}


@pytest.fixture
def pair(request):
    """(JAX app port, port app port, port handler): both apps over the
    spec and admission the test names (``request.param``)."""
    graph, comps, admission = getattr(request, "param", (GRAPH, None, None))
    spec = {"name": "p", "graph": graph}
    j = JaxEngine(JaxSpec.from_dict(spec), components=comps(JaxComponent) if comps else None)
    p = GraphEngine(PredictorSpec.from_dict(spec),
                    components=comps(SeldonComponent) if comps else None, device="cpu")
    jadm = JaxAdmission(**admission) if admission else None
    padm = AdmissionController(**admission) if admission else None
    jport, jstop = jax_threaded_app(jax_engine_app(j, admission=jadm))
    handler = make_engine_app(p, admission=padm, device="cpu")
    httpd, _ = start(handler)
    try:
        yield jport, httpd.server_address[1], handler, (jadm, padm)
    finally:
        jstop()
        httpd.shutdown()
        httpd.server_close()


def bodies():
    rng = np.random.default_rng(0)
    out = []
    for i in range(8):
        x = rng.standard_normal((1 + i % 3, 2)).round(3)
        data = ({"tensor": {"shape": list(x.shape), "values": x.ravel().tolist()}} if i % 2
                else {"ndarray": x.tolist()})
        out.append({"meta": {"puid": f"p{i}"}, "data": data})
    return out


def families(text):
    return {f.name: f for f in text_string_to_metric_families(text)}


def test_predictions_feedback_and_scrape_equal_jax(pair):
    jport, pport, _, _ = pair
    for i, body in enumerate(bodies()):
        path = "/predict" if i == 3 else "/api/v0.1/predictions"
        want = request(jport, path, body)
        got = request(pport, path, body)
        assert got[:2] == want[:2]
        resp = json.loads(got[1])
        fb_path = "/send-feedback" if i == 5 else "/api/v0.1/feedback"
        fb = {"request": body, "response": resp, "reward": float(i % 2)}
        assert request(pport, fb_path, fb)[:2] == request(jport, fb_path, fb)[:2]
    metas = []
    for b in bodies():
        got = request(pport, "/api/v0.1/predictions", b)
        assert got[:2] == request(jport, "/api/v0.1/predictions", b)[:2]
        metas.append(json.loads(got[1])["meta"])
    assert {m["routing"]["router"] for m in metas} == {0, 1}
    assert all(m["tags"]["bandit"] == "EpsilonGreedy" for m in metas)
    want = families(request(jport, "/metrics")[1])
    got = families(request(pport, "/metrics")[1])
    # the router's own metrics stay in its route answer (the engine merges
    # only its tags and routing), as in the JAX package
    assert got.keys() >= {"seldon_api_model_feedback", "seldon_api_model_feedback_reward",
                          "mycounter", "mygauge", "mytimer", "seldon_resilience_inflight",
                          "seldon_resilience_shed"}
    assert not any(name.startswith("bandit") for name in set(got) | set(want))
    for name, fam in got.items():
        if not (name.startswith("seldon_api") or name.startswith("seldon_resilience")
                or not name.startswith("seldon_")):
            continue
        samples = fam.samples
        want_samples = want[name].samples
        if fam.type == "histogram" and name.startswith("seldon_api"):
            samples = [s for s in samples if s.name.endswith("_count")]
            want_samples = [s for s in want_samples if s.name.endswith("_count")]
        assert (fam.type, fam.documentation, samples) == \
            (want[name].type, want[name].documentation, want_samples), name


@pytest.mark.parametrize("path,body,raw,method,headers", [
    ("/api/v0.1/predictions", None, b"{bad", None, {}),
    ("/api/v0.1/feedback", None, b"{bad", None, {}),
    ("/seldon.json", None, None, None, {}),
    ("/live", None, None, None, {}),
    ("/ping", None, None, None, {}),
    ("/profile", None, b"", "POST", {}),
], ids=["malformed predict", "malformed feedback", "seldon.json", "live", "ping",
        "profile disabled"])
def test_routes_answer_as_jax(pair, monkeypatch, path, body, raw, method, headers):
    monkeypatch.delenv("SELDON_PROFILE_DIR", raising=False)
    jport, pport, _, _ = pair
    want = request(jport, path, body, headers, method, raw)
    got = request(pport, path, body, headers, method, raw)
    assert got[:2] == want[:2]


def test_pause_unpause_ready_as_jax(pair):
    jport, pport, handler, _ = pair
    body = bodies()[0]
    steps = [("/ready", None), ("/pause", "POST"), ("/ready", None),
             ("/api/v0.1/predictions", body), ("/unpause", "GET"), ("/ready", None),
             ("/pause", "GET"), ("/unpause", "POST"), ("/api/v0.1/predictions", body)]
    seen = []
    for path, arg in steps:
        kw = dict(body=arg) if isinstance(arg, dict) else dict(method=arg,
                                                                raw=b"" if arg == "POST" else None)
        got = request(pport, path, **kw)
        assert got[:2] == request(jport, path, **kw)[:2], path
        seen.append(got[0])
    assert seen == [200, 200, 503, 503, 200, 200, 200, 200, 200]
    assert handler.state == {"paused": False, "ready": True}


@pytest.mark.parametrize("pair", [(GRAPH, None, dict(max_inflight=1, max_queue=0,
                                                     retry_after_s=3))], indirect=True)
def test_admission_shed_503_with_retry_after_as_jax(pair):
    jport, pport, _, (jadm, padm) = pair
    body = bodies()[1]
    jadm.acquire_sync()
    padm.acquire_sync()
    want = request(jport, "/api/v0.1/predictions", body)
    got = request(pport, "/api/v0.1/predictions", body)
    assert got[:2] == want[:2] and got[0] == 503
    assert got[2]["Retry-After"] == want[2]["Retry-After"] == "3"
    jadm.release()
    padm.release()
    assert request(pport, "/api/v0.1/predictions", body)[:2] == \
        request(jport, "/api/v0.1/predictions", body)[:2]
    shed = [families(request(port, "/metrics")[1])["seldon_resilience_shed"].samples
            for port in (jport, pport)]
    assert shed[0] == shed[1] and shed[1][0].value == 1.0


@pytest.mark.parametrize("pair", [(SLOW_CHAIN, slow, None)], indirect=True)
def test_spent_deadline_answers_504_as_jax(pair):
    jport, pport, _, _ = pair
    body = bodies()[1]
    hdr = {"Seldon-Deadline-Ms": "20"}
    want = request(jport, "/api/v0.1/predictions", body, hdr)
    got = request(pport, "/api/v0.1/predictions", body, hdr)
    assert got[0] == want[0] == 504
    strip = [{k: v for k, v in json.loads(r[1])["status"].items() if k != "info"}
             for r in (got, want)]
    assert strip[0] == strip[1] == {"code": 504, "reason": "DEADLINE_EXCEEDED",
                                    "status": "FAILURE"}
    assert "node m" in json.loads(got[1])["status"]["info"]
    # a generous budget serves, and leaves a remaining-budget observation
    ok = request(pport, "/api/v0.1/predictions", body, {"Seldon-Deadline-Ms": "60000"})
    assert ok[:2] == request(jport, "/api/v0.1/predictions", body,
                             {"Seldon-Deadline-Ms": "60000"})[:2]
    fams = [families(request(port, "/metrics")[1]) for port in (jport, pport)]
    for name in ("seldon_resilience_deadline_exceeded",):
        assert fams[1][name].samples == fams[0][name].samples
    assert fams[1]["seldon_resilience_remaining_budget_seconds"].samples[-2].value == 1.0


def test_profile_debug_timeline_and_logging(pair, tmp_path, monkeypatch, capfd):
    jport, pport, _, _ = pair
    monkeypatch.setenv("SELDON_PROFILE_DIR", str(tmp_path))
    code, text, _ = request(pport, "/profile?seconds=0.2", method="POST", raw=b"")
    out = json.loads(text)
    assert code == 200 and out["seconds"] == 0.2
    assert os.path.getsize(os.path.join(out["trace_dir"], "trace.json")) > 0
    for path in ("/debug/timeline", "/debug/timeline?n=3"):
        code, text, _ = request(pport, path)
        jcode, jtext, _ = request(jport, path)
        assert (code, json.loads(text)) == (jcode, json.loads(jtext))
        assert code == 200

    posted, got = [], threading.Event()

    class Sink(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers["Content-Length"])
            posted.append((self.headers, json.loads(self.rfile.read(n))))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()
            got.set()

        def log_message(self, *args):
            pass

    sink = ThreadingHTTPServer(("127.0.0.1", 0), Sink)
    threading.Thread(target=sink.serve_forever, daemon=True).start()
    monkeypatch.setenv("SELDON_LOG_REQUESTS", "1")
    monkeypatch.setenv("SELDON_LOG_RESPONSES", "1")
    monkeypatch.setenv("REQUEST_LOGGER_URL", f"http://127.0.0.1:{sink.server_address[1]}/")
    engine = GraphEngine(PredictorSpec.from_dict({"name": "p", "graph": dict(SIMPLE, name="m")}),
                         device="cpu")
    httpd, _ = start(make_engine_app(engine, device="cpu"))
    try:
        body = bodies()[0]
        code, text, _ = request(httpd.server_address[1], "/api/v0.1/predictions", body)
        assert code == 200 and got.wait(10)
    finally:
        httpd.shutdown()
        httpd.server_close()
        sink.shutdown()
        sink.server_close()
    headers, pair_posted = posted[0]
    assert pair_posted == {"request": body, "response": json.loads(text)}
    assert headers["CE-Type"] == "seldon.message.pair" and headers["CE-RequestId"] == "p0"
    printed = [json.loads(line) for line in capfd.readouterr().out.splitlines()
               if line.startswith("{")]
    assert {"request": body} in printed and {"response": json.loads(text)} in printed


def test_grpc_engine_server_answers_as_jax():
    """``Seldon/Predict`` and ``Seldon/SendFeedback`` on the port's gRPC
    engine server answer the JAX engine server's replies (fresh engines of
    the same spec); a non-numeric payload is INTERNAL on both."""
    spec = {"name": "p", "graph": GRAPH}
    servers = [jax_engine_server(JaxEngine(JaxSpec.from_dict(spec)), port=None),
               make_engine_server(GraphEngine(PredictorSpec.from_dict(spec), device="cpu"),
                                  port=None)]
    targets = []
    for server in servers:
        targets.append(f"127.0.0.1:{server.add_insecure_port('127.0.0.1:0')}")
        server.start()

    def call(target, method, msg, **kw):
        try:
            return grpc_client.call_sync(target, method, msg, service="Seldon",
                                         timeout_s=TIMEOUT, **kw).to_dict()
        except grpc.RpcError as e:
            return e.code(), e.details().split(":")[0]

    try:
        for i, body in enumerate(bodies()[:6]):
            jt, pt = [call(t, "Predict", JaxMessage.from_dict(body)) for t in targets]
            assert pt == jt
            fb = JaxFeedback.from_dict({"request": body, "response": pt, "reward": i % 2})
            assert call(targets[1], "SendFeedback", fb) == call(targets[0], "SendFeedback", fb)
        bad = JaxMessage.from_dict({"meta": {"puid": "bad"}, "data": {"ndarray": [["a", "b"]]}})
        got = [call(t, "Predict", bad) for t in targets]
        assert got[0] == got[1] and got[1][0] == grpc.StatusCode.INTERNAL
    finally:
        for server in servers:
            server.stop(None)


def test_grpc_deadline_metadata_as_jax():
    engines = [JaxEngine(JaxSpec.from_dict({"name": "p", "graph": SLOW_CHAIN}),
                         components=slow(JaxComponent)),
               GraphEngine(PredictorSpec.from_dict({"name": "p", "graph": SLOW_CHAIN}),
                           components=slow(SeldonComponent), device="cpu")]
    servers = [jax_engine_server(engines[0], port=None), make_engine_server(engines[1],
                                                                            port=None)]
    codes = []
    try:
        for server in servers:
            target = f"127.0.0.1:{server.add_insecure_port('127.0.0.1:0')}"
            server.start()
            with pytest.raises(grpc.RpcError) as e:
                grpc_client.call_sync(target, "Predict", JaxMessage.from_dict(bodies()[1]),
                                      service="Seldon", timeout_s=None,
                                      metadata=[("seldon-deadline-ms", "20")])
            codes.append((e.value.code(), "node m" in e.value.details()))
    finally:
        for server in servers:
            server.stop(None)
    assert codes[1] == codes[0] == (grpc.StatusCode.DEADLINE_EXCEEDED, True)


def test_engine_app_refuses_the_cpu_unasked(monkeypatch):
    engine = GraphEngine(PredictorSpec.from_dict({"name": "p", "graph": dict(SIMPLE, name="m")}),
                         device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_engine_app(engine)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="engine device"):
        make_engine_app(engine)
