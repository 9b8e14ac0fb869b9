"""The component app's admission gate in the port
(``transport/rest.make_component_app``: ``AdmissionController``,
``wire_retry_after``, ``sync_resilience(..., transport="rest")``) held
against the JAX component app on the CPU: with the controller's one slot
held, a method call answers 503 with the same ``Retry-After`` (the
configured constant, or a component's batcher backlog hint above it) and
``/v1/generate`` is not gated; with the slot released it answers 200; the
scrape's request and ``seldon_resilience_*`` series equal the JAX app's."""

import asyncio
import json
import socket
import threading
import urllib.error
import urllib.request

import pytest
from aiohttp import web
from prometheus_client.parser import text_string_to_metric_families

from seldon_core_tpu.runtime.resilience import AdmissionController as JaxAdmission
from seldon_core_tpu.transport.rest import make_component_app as jax_app
from seldon_core_tpu_torch.runtime.resilience import AdmissionController
from seldon_core_tpu_torch.transport.rest import make_component_app, start

TIMEOUT = 30
BODY = {"data": {"ndarray": [[1.0, 2.0]]}}


class Echo:
    def predict(self, X, names, meta=None):
        return X


class Gen(Echo):
    def generate(self, prompts, *args, **kwargs):
        return {"tokens": [[1, 2]], "texts": ["ab"]}


class _Batcher:
    def retry_after_hint(self):
        return 7.0


class _Service:
    batcher = _Batcher()


class Backlogged(Echo):
    """A component whose shared batcher reports a backlog of 7 s."""
    _batcher_service = _Service()


def serve_jax(comp, admission):
    app = jax_app(comp, admission=admission)
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


def serve_port(comp, admission):
    httpd, _ = start(make_component_app(comp, device="cpu", admission=admission))

    def stop():
        httpd.shutdown()
        httpd.server_close()

    return httpd.server_address[1], stop


def call(port, path, body=BODY):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.headers.get("Retry-After")
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After")


def scrape(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=TIMEOUT) as r:
        return {f.name: f for f in text_string_to_metric_families(r.read().decode())}


SERIES = ("seldon_api_executor_server_requests", "seldon_resilience_shed",
          "seldon_resilience_inflight", "seldon_resilience_queue_depth")


@pytest.mark.parametrize("comp,retry", [(Echo, "2"), (Backlogged, "7")],
                         ids=["constant", "backlog"])
def test_gate_codes_and_series_equal_jax(comp, retry):
    runs = []
    for serve, Adm in ((serve_jax, JaxAdmission), (serve_port, AdmissionController)):
        adm = Adm(max_inflight=1, max_queue=0, retry_after_s=2.0)
        port, stop = serve(comp(), adm)
        try:
            adm.acquire_sync()    # the one slot taken: every method call sheds
            shed = [call(port, "/predict"), call(port, "/api/v0.1/predictions"),
                    call(port, "/transform-input")]
            adm.release()
            ok = [call(port, "/predict"), call(port, "/transform-input")]
            fams = scrape(port)
            runs.append((shed, ok, {n: sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                                              for s in fams[n].samples
                                              if not s.name.endswith("_created"))
                                    for n in SERIES}, adm.shed_total, adm.inflight))
        finally:
            stop()
    assert runs[0] == runs[1]
    shed, ok, series, shed_total, inflight = runs[1]
    assert shed == [(503, retry)] * 3 and [c for c, _ in ok] == [200, 200]
    assert (shed_total, inflight) == (3, 0)
    assert ("seldon_resilience_shed_total", (("deployment_name", ""), ("predictor_name", ""),
                                             ("transport", "rest")), 3.0) in series[
        "seldon_resilience_shed"]


def test_generate_is_not_gated():
    """``/v1/generate`` bypasses the gate in both apps: a full controller
    does not shed it."""
    codes = []
    for serve, Adm in ((serve_jax, JaxAdmission), (serve_port, AdmissionController)):
        adm = Adm(max_inflight=1, max_queue=0)
        port, stop = serve(Gen(), adm)
        try:
            adm.acquire_sync()
            codes.append(call(port, "/v1/generate", {"prompt": "hi"})[0])
            adm.release()
        finally:
            stop()
    assert codes == [200, 200]
