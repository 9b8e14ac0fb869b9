"""The port's host-side clients held against the JAX package's on the CPU:
the load generator (``client/loadgen.py``) across both packages' engine
apps, ``SeldonClient`` over REST, gRPC and the gateway with TLS, the
contract fuzzing and testers, the request logger, the dashboards, the
Containerfile of ``packaging/wrap.py``, ``SageMakerProxy`` and the five
ported CLI subcommands.

Answers are compared exactly (the same SIMPLE_MODEL graph answers the same
floats); the load generator runs 1 s a transport with 0.2 s of warm-up and
must report no error; the logger's lines are compared as parsed JSON."""

import asyncio
import http.server
import json
import os
import re
import socket
import ssl
import subprocess
import threading
import urllib.request

import grpc
import numpy as np
import pytest
from aiohttp import web

from seldon_core_tpu.benchmarks import loadgen as jax_loadgen
from seldon_core_tpu.client import contract as jax_contract
from seldon_core_tpu.client.client import SeldonClient as JaxClient
from seldon_core_tpu.contracts.graph import PredictorSpec as JaxSpec
from seldon_core_tpu.observability import dashboards as jax_dashboards
from seldon_core_tpu.observability.request_logger import flatten_pair as jax_flatten
from seldon_core_tpu.packaging.wrap import containerfile_for_model as jax_containerfile
from seldon_core_tpu.runtime.engine import GraphEngine as JaxEngine
from seldon_core_tpu.transport.rest import make_engine_app as jax_engine_app
from seldon_core_tpu_torch.client import contract, loadgen
from seldon_core_tpu_torch.client.client import SeldonClient
from seldon_core_tpu_torch.client.testers import run_contract_test
from seldon_core_tpu_torch.components.builtin import SimpleModel
from seldon_core_tpu_torch.contracts.graph import PredictorSpec
from seldon_core_tpu_torch.contracts.payload import SeldonError, SeldonMessage
from seldon_core_tpu_torch.controlplane.render import DEFAULT_ENGINE_IMAGE
from seldon_core_tpu_torch.integrations import SageMakerProxy
from seldon_core_tpu_torch.metrics.registry import MetricsRegistry
from seldon_core_tpu_torch.observability import dashboards
from seldon_core_tpu_torch.observability.request_logger import flatten_pair, make_logger_app
from seldon_core_tpu_torch.packaging.wrap import containerfile_for_model
from seldon_core_tpu_torch.runtime.engine import GraphEngine
from seldon_core_tpu_torch.transport.grpc_server import make_component_server, make_engine_server
from seldon_core_tpu_torch.transport.rest import make_component_app, make_engine_app, start

SPEC = {"name": "p", "graph": {"name": "m", "type": "MODEL", "implementation": "SIMPLE_MODEL"}}
REPORT_KEYS = {"transport", "clients", "duration_s", "requests", "errors", "rps", "p50_ms",
               "p90_ms", "p95_ms", "p99_ms", "mean_ms", "max_ms"}
X = np.array([[1.0, 2.0]])


def port_engine():
    return GraphEngine(PredictorSpec.from_dict(SPEC), device="cpu")


@pytest.fixture
def served(request):
    """Stop every server the test starts."""
    stops = []
    yield stops
    for stop in stops:
        stop()


def serve_port_app(app, stops, tls=None):
    httpd, _ = start(app) if tls is None else _start_tls(app, tls)
    stops.append(lambda: (httpd.shutdown(), httpd.server_close()))
    return httpd.server_address[1]


def _start_tls(app, cert):
    key, crt = cert
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), app)
    httpd.daemon_threads = True
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(crt, key)
    httpd.socket = ctx.wrap_socket(httpd.socket, server_side=True)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, None


def serve_jax_app(app, stops):
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
    stops.append(lambda: loop.call_soon_threadsafe(loop.stop))
    return sock.getsockname()[1]


def serve_grpc(server, stops, creds=None):
    port = (server.add_secure_port("localhost:0", creds) if creds
            else server.add_insecure_port("127.0.0.1:0"))
    server.start()
    stops.append(lambda: server.stop(None))
    return port


@pytest.fixture(scope="module")
def cert(tmp_path_factory):
    d = tmp_path_factory.mktemp("tls")
    key, crt = str(d / "key.pem"), str(d / "cert.pem")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key, "-out",
                    crt, "-days", "1", "-nodes", "-subj", "/CN=localhost", "-addext",
                    "subjectAltName=DNS:localhost,IP:127.0.0.1"],
                   check=True, capture_output=True)
    return key, crt


# ------------------------------------------------------------ load generator
@pytest.mark.parametrize("latencies", [[], [0.004], list(np.random.default_rng(0).exponential(
    0.01, 997))])
def test_percentile_stats_equal_jax(latencies):
    assert loadgen.percentile_stats(latencies) == jax_loadgen.percentile_stats(latencies)


def test_port_loadgen_against_jax_engine_app(served):
    port = serve_jax_app(jax_engine_app(JaxEngine(JaxSpec.from_dict(SPEC))), served)
    warm = {}
    report = loadgen.run_rest_load(f"http://127.0.0.1:{port}/api/v0.1/predictions",
                                   loadgen.default_payload_fn(), clients=4, duration_s=1.0,
                                   warmup_s=0.2, warmup_stats=warm)
    assert set(report) == REPORT_KEYS and report["transport"] == "rest"
    assert report["errors"] == 0 and report["requests"] > 10 and warm["requests"] > 0
    assert warm["errors"] == 0 and report["p50_ms"] > 0 and report["rps"] > 10


def test_jax_loadgen_against_port_engine_app(served):
    port = serve_port_app(make_engine_app(port_engine(), device="cpu"), served)
    report = asyncio.run(jax_loadgen.run_rest_load(
        f"http://127.0.0.1:{port}/api/v0.1/predictions", jax_loadgen.default_payload_fn(),
        clients=4, duration_s=1.0, warmup_s=0.2))
    assert set(report) == REPORT_KEYS
    assert report["errors"] == 0 and report["requests"] > 10


def test_port_grpc_loadgen_against_port_engine_server(served):
    port = serve_grpc(make_engine_server(port_engine(), port=None), served)
    msg = SeldonMessage.from_dict(loadgen.default_payload_fn(batch=2)())
    report = loadgen.run_grpc_load(f"127.0.0.1:{port}", lambda: msg, clients=4, duration_s=1.0,
                                   warmup_s=0.2)
    assert set(report) == REPORT_KEYS and report["transport"] == "grpc"
    assert report["errors"] == 0 and report["requests"] > 10


def test_loadgen_counts_errors(served):
    """A refused request counts as an error, not as a latency."""
    port = serve_port_app(make_engine_app(port_engine(), device="cpu"), served)
    bad = lambda: {"data": {"tensor": {"shape": [1, 3], "values": [1.0]}}}  # noqa: E731
    report = loadgen.run_rest_load(f"http://127.0.0.1:{port}/api/v0.1/predictions", bad,
                                   clients=2, duration_s=0.3, warmup_s=0.1)
    assert report["requests"] == 0 and report["errors"] > 0


# ------------------------------------------------------------- SeldonClient
def _same_answer(port_resp, jax_resp):
    assert port_resp.success and jax_resp.success, (port_resp.error, jax_resp.error)
    np.testing.assert_array_equal(port_resp.data, jax_resp.data)
    assert port_resp.raw["data"] == jax_resp.raw["data"]


def test_client_rest_and_feedback_on_port_engine_app(served):
    port = serve_port_app(make_engine_app(port_engine(), device="cpu"), served)
    mine, theirs = SeldonClient(port=port), JaxClient(port=port)
    _same_answer(mine.predict(X), theirs.predict(X))
    _same_answer(mine.predict(X, names=["a", "b"]), theirs.predict(X, names=["a", "b"]))
    assert mine.feedback(reward=1.0).success and theirs.feedback(reward=1.0).success
    assert mine.predict(str_data="hi").success == theirs.predict(str_data="hi").success
    refused = SeldonClient(port=port, endpoint_kind="gateway", deployment_name="d").predict(X)
    assert not refused.success and refused.error and refused.raw is not None
    down = SeldonClient(port=1, timeout_s=2).predict(X)
    assert not down.success and down.msg is None and down.error


def test_client_grpc_and_microservice_on_port_servers(served):
    gport = serve_grpc(make_engine_server(port_engine(), port=None), served)
    mine = SeldonClient(port=gport, transport="grpc")
    _same_answer(mine.predict(X), JaxClient(port=gport, transport="grpc").predict(X))
    assert mine.feedback(reward=0.5).success
    cport = serve_port_app(make_component_app(SimpleModel(), device="cpu"), served)
    unit = SeldonClient(port=cport, endpoint_kind="microservice")
    _same_answer(unit.predict(X), JaxClient(port=cport, endpoint_kind="microservice").predict(X))
    _same_answer(unit.transform_input(X),
                 JaxClient(port=cport, endpoint_kind="microservice").transform_input(X))
    mport = serve_grpc(make_component_server(SimpleModel(), port=None), served)
    gunit = SeldonClient(port=mport, transport="grpc", endpoint_kind="microservice")
    _same_answer(gunit.predict(X), JaxClient(port=mport, transport="grpc",
                                             endpoint_kind="microservice").predict(X))
    with pytest.raises(ValueError, match="microservice-level"):
        mine.route(X)


def _gateway(app, prefix):
    class Gateway(app):
        """An ingress in front of the engine app: only the prefixed path."""

        def do_POST(self):
            if not self.path.startswith(prefix):
                self._not_found(self.path)
                return
            self.path = self.path[len(prefix):]
            super().do_POST()

    return Gateway


def test_client_gateway_rest_over_tls(served, cert):
    app = _gateway(make_engine_app(port_engine(), device="cpu"), "/seldon/ns1/mydep")
    port = serve_port_app(app, served, tls=cert)
    kw = dict(host="localhost", port=port, endpoint_kind="gateway", deployment_name="mydep",
              namespace="ns1", ssl=True, ca_cert=cert[1], auth_token="tok")
    _same_answer(SeldonClient(**kw).predict(X), JaxClient(**kw).predict(X))
    assert SeldonClient(**kw).feedback(reward=1.0).success
    assert not SeldonClient(**dict(kw, deployment_name="other")).predict(X).success
    assert not SeldonClient(**dict(kw, ssl=False)).predict(X).success   # plain http on TLS
    assert not SeldonClient(**dict(kw, ca_cert=None)).predict(X).success  # unknown issuer


def test_client_grpc_gateway_metadata_and_tls(served, cert):
    key, crt = cert
    with open(key, "rb") as f, open(crt, "rb") as g:
        creds = grpc.ssl_server_credentials([(f.read(), g.read())])
    seen = []

    def predict(request, context):
        seen.append(dict(context.invocation_metadata()))
        return request

    from seldon_core_tpu_torch.transport.proto import prediction_pb2 as pb

    server = grpc.server(__import__("concurrent.futures").futures.ThreadPoolExecutor(2))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "seldon.protos.Seldon", {"Predict": grpc.unary_unary_rpc_method_handler(
            predict, request_deserializer=pb.SeldonMessage.FromString,
            response_serializer=lambda m: m.SerializeToString())}),))
    port = serve_grpc(server, served, creds=creds)
    kw = dict(host="localhost", port=port, transport="grpc", endpoint_kind="gateway",
              deployment_name="mydep", namespace="ns1", auth_token="tok123", ssl=True,
              ca_cert=crt, timeout_s=10)
    _same_answer(SeldonClient(**kw).predict(X), JaxClient(**kw).predict(X))
    assert seen[0]["seldon"] == "mydep" and seen[0]["namespace"] == "ns1"
    assert seen[0]["authorization"] == "Bearer tok123"
    assert {k: seen[0][k] for k in ("seldon", "namespace", "authorization")} == \
        {k: seen[1][k] for k in ("seldon", "namespace", "authorization")}
    assert not SeldonClient(**dict(kw, ssl=False, timeout_s=3)).predict(X).success
    with pytest.raises(ValueError, match="deployment_name"):
        SeldonClient(endpoint_kind="gateway")


# ------------------------------------------------------- contracts, testers
CONTRACT = {"features": [{"name": "x", "ftype": "continuous", "dtype": "FLOAT",
                          "range": [0, 1], "shape": [2]},
                         {"name": "n", "ftype": "continuous", "range": ["-inf", 2]},
                         {"name": "i", "ftype": "continuous", "dtype": "INT",
                          "range": [0, "inf"]},
                         {"name": "c", "ftype": "categorical", "values": ["a", "b"]}],
            "targets": [{"name": "p", "ftype": "continuous", "range": [0, 1]}]}


@pytest.mark.parametrize("seed", [0, 5])
def test_contract_generation_and_validation_equal_jax(seed):
    assert contract.unfold_contract(CONTRACT) == jax_contract.unfold_contract(CONTRACT)
    got = contract.generate_batch(CONTRACT, 6, seed=seed)
    want = jax_contract.generate_batch(CONTRACT, 6, seed=seed)
    assert got.dtype == want.dtype and (got == want).all()
    numeric = {"features": CONTRACT["features"][:3]}
    np.testing.assert_array_equal(contract.generate_batch(numeric, 4, seed=seed),
                                  jax_contract.generate_batch(numeric, 4, seed=seed))
    assert contract.feature_names(CONTRACT) == jax_contract.feature_names(CONTRACT)
    for resp in ([[0.5]], [[1.5]], [[0.1, 0.2]]):
        assert contract.validate_response(CONTRACT, resp) == \
            jax_contract.validate_response(CONTRACT, resp)


def test_contract_from_dataframe_equal_jax():
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({"a": [1.0, 2.5], "k": [1, 2], "s": ["x", "y"]})
    assert contract.contract_from_dataframe(df) == jax_contract.contract_from_dataframe(df)


def test_testers_against_port_apps(served, tmp_path, capsys):
    path = tmp_path / "contract.json"
    path.write_text(json.dumps({"features": [{"name": "f", "ftype": "continuous",
                                              "range": [0, 1], "shape": [4]}]}))
    eport = serve_port_app(make_engine_app(port_engine(), device="cpu"), served)
    assert run_contract_test(str(path), "127.0.0.1", eport, n_requests=3, batch_size=2,
                             endpoint_kind="engine", seed=1) == 0
    assert run_contract_test(str(path), "127.0.0.1", eport, endpoint_kind="engine",
                             method="send-feedback") == 0
    cport = serve_port_app(make_component_app(SimpleModel(), device="cpu"), served)
    assert run_contract_test(str(path), "127.0.0.1", cport, n_requests=2) == 0
    assert "2/2 requests passed" in capsys.readouterr().out
    assert run_contract_test(str(path), "127.0.0.1", 1, n_requests=2) == 2


# ------------------------------------------------------------ request logger
PAIRS = [
    {"request": {"meta": {"puid": "r1"}, "data": {"ndarray": [[1.0, 2.0], [3.0, 4.0]]}},
     "response": {"data": {"tensor": {"shape": [2, 3], "values": [0.1, 0.9, 0.5] * 2}}}},
    {"request": {"strData": "hello"}, "response": {"jsonData": {"k": 1}}},
    {"request": {"data": {"tensor": {"shape": [3], "values": [1, 2, 3]}}}, "response": {}},
]
CE = {"CE-Type": "seldon.message.pair", "CE-Source": "src", "CE-SDep": "dep",
      "CE-RequestId": "rid"}


def _post(url, body, headers=None, raw=None):
    req = urllib.request.Request(url, data=raw if raw is not None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Lines:
    def __init__(self):
        self.text = ""
        self.cv = threading.Condition()

    def write(self, s):
        with self.cv:
            self.text += s
            self.cv.notify_all()

    def flush(self):
        pass

    def records(self, n=0, timeout=10.0):
        with self.cv:
            self.cv.wait_for(lambda: self.text.count("\n") >= n, timeout)
            return [json.loads(line) for line in self.text.splitlines()]


def test_request_logger_lines_equal_jax(served):
    out = _Lines()
    port = serve_port_app(make_logger_app(out), served)
    want = []
    ce = {k.lower(): v for k, v in CE.items()}
    for pair in PAIRS:
        assert _post(f"http://127.0.0.1:{port}/", pair, CE) == (200, {"status": "ok"})
        assert flatten_pair(pair, ce) == jax_flatten(pair, ce)
        want += jax_flatten(pair, ce)
    assert _post(f"http://127.0.0.1:{port}/api/log", PAIRS[0]) == (200, {"status": "ok"})
    want += jax_flatten(PAIRS[0], {})
    assert out.records() == json.loads(json.dumps(want))
    assert _post(f"http://127.0.0.1:{port}/", None, raw=b"{bad") == (400, {"error": "bad json"})
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/ready", timeout=10) as r:
        assert json.loads(r.read()) == {"status": "ok"}


def test_engine_app_logs_each_pair_to_the_port_logger(served, monkeypatch):
    out = _Lines()
    lport = serve_port_app(make_logger_app(out), served)
    monkeypatch.setenv("REQUEST_LOGGER_URL", f"http://127.0.0.1:{lport}/")
    eport = serve_port_app(make_engine_app(port_engine(), device="cpu"), served)
    for i in range(3):
        body = {"meta": {"puid": f"q{i}"}, "data": {"ndarray": [[float(i), 1.0]]}}
        assert _post(f"http://127.0.0.1:{eport}/api/v0.1/predictions", body)[0] == 200
    records = out.records(3)
    assert sorted(r["request.id"] for r in records) == ["q0", "q1", "q2"]
    assert all(r["ce-type"] == "seldon.message.pair" and r["request.elem"] == 0 for r in records)
    by_id = {r["request.id"]: r for r in records}
    assert by_id["q2"]["request.data"] == [2.0, 1.0]


# ----------------------------------------------------------------- artifacts
def test_dashboards_equal_jax_and_query_registered_names(tmp_path):
    assert dashboards.prometheus_scrape_config() == jax_dashboards.prometheus_scrape_config()
    assert dashboards.prometheus_alert_rules() == jax_dashboards.prometheus_alert_rules()
    assert dashboards.predictions_dashboard() == jax_dashboards.predictions_dashboard()
    mine = dashboards.write_artifacts(str(tmp_path / "port"))
    theirs = jax_dashboards.write_artifacts(str(tmp_path / "jax"))
    assert [os.path.relpath(p, tmp_path / "port") for p in mine] == \
        [os.path.relpath(p, tmp_path / "jax") for p in theirs]
    for a, b in zip(mine, theirs):
        assert open(a).read() == open(b).read()
    exposed = MetricsRegistry(deployment="d", predictor="p").expose().decode()
    families = set(re.findall(r"^# TYPE (\S+) ", exposed, re.M))
    text = json.dumps([dashboards.prometheus_alert_rules(), dashboards.predictions_dashboard()])
    names = set(re.findall(r"(seldon_[a-z_]+)", text))
    assert len(names) >= 8
    for name in names:
        base = re.sub(r"_(bucket|sum|count|total)$", "", name)
        assert name in families or base in families, name


def test_dashboards_name_missing_yaml(monkeypatch, tmp_path):
    monkeypatch.setitem(__import__("sys").modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        dashboards.write_artifacts(str(tmp_path))


@pytest.mark.parametrize("api,req,persist", [("REST", False, False), ("grpc", True, True)])
def test_containerfile_differs_from_jax_only_in_module(api, req, persist):
    kw = dict(api=api, install_requirements=req, persistence=persist)
    mine = containerfile_for_model("MyModel", **kw)
    want = jax_containerfile("MyModel", base_image=DEFAULT_ENGINE_IMAGE, **kw)
    assert f"FROM {DEFAULT_ENGINE_IMAGE}\n" in mine
    assert "python -m seldon_core_tpu_torch.transport.cli microservice" in mine
    assert mine.replace("seldon_core_tpu_torch.", "seldon_core_tpu.") == want
    with pytest.raises(ValueError, match="REST or GRPC"):
        containerfile_for_model("MyModel", api="IPC")


# --------------------------------------------------------------- SageMaker
def test_sagemaker_proxy_json_and_csv(served):
    mode = {"kind": "json"}

    class Stub(http.server.BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_POST(self):
            assert self.path == "/invocations"
            x = np.asarray(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
            kind = mode["kind"]
            if kind == "err":
                self.send_response(500)
                self.end_headers()
                self.wfile.write(b"boom")
                return
            body, ctype = {
                "json": (json.dumps((x * 2).tolist()), "application/json"),
                "flat": (json.dumps((x[:, 0] * 2).tolist()), "application/json"),
                "csv": ("\n".join(",".join(str(v) for v in row) for row in x * 3) + "\n",
                        "text/csv"),
            }[kind]
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.end_headers()
            self.wfile.write(body.encode())

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    served.append(lambda: (httpd.shutdown(), httpd.server_close()))
    proxy = SageMakerProxy(endpoint=f"http://127.0.0.1:{httpd.server_address[1]}/")
    x = np.array([[1.0, 2.0], [3.0, 4.0]])
    np.testing.assert_allclose(proxy.predict(x, []), x * 2)
    mode["kind"] = "flat"
    np.testing.assert_allclose(proxy.predict(x, []), (x[:, 0] * 2)[:, None])
    mode["kind"] = "csv"
    np.testing.assert_allclose(proxy.predict(x, []), x * 3)
    mode["kind"] = "err"
    with pytest.raises(SeldonError, match="SageMaker endpoint error 500") as e:
        proxy.predict(x, [])
    assert e.value.status_code == 502
    with pytest.raises(SeldonError, match="endpoint"):
        SageMakerProxy()


# ---------------------------------------------------------------------- CLI
class _Parsed(Exception):
    pass


def _subparsers(main, monkeypatch):
    import argparse

    def capture(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_known_args", capture)
    with pytest.raises(_Parsed) as e:
        main([])
    monkeypatch.undo()
    sub = next(a for a in e.value.args[0]._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices


@pytest.mark.parametrize("command", ["tester", "api-tester", "analytics", "request-logger",
                                     "loadtest"])
def test_cli_subcommand_arguments_equal_jax(command, monkeypatch):
    from seldon_core_tpu.transport.cli import main as jax_main
    from seldon_core_tpu_torch.transport.cli import main

    def shape(p):
        return ([(a.dest, a.option_strings, a.default, a.type, a.nargs, a.choices, a.required)
                 for a in p._actions],
                {k: v for k, v in p._defaults.items() if k != "func"})

    assert shape(_subparsers(main, monkeypatch)[command]) == \
        shape(_subparsers(jax_main, monkeypatch)[command])


def test_cli_native_edge_commands_name_the_slice(capsys):
    from seldon_core_tpu_torch.transport.cli import main

    for command in ("edge", "loadtest-native", "loadtest-worker", "loadtest-fleet"):
        with pytest.raises(SystemExit, match="native-edge slice"):
            main([command, "127.0.0.1", "8000", "--connections", "4"])


def test_cli_loadtest_and_analytics(served, tmp_path, capsys):
    from seldon_core_tpu_torch.transport.cli import main

    port = serve_port_app(make_engine_app(port_engine(), device="cpu"), served)
    main(["loadtest", "127.0.0.1", str(port), "--clients", "2", "--duration", "0.5"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == REPORT_KEYS and report["errors"] == 0 and report["requests"] > 0
    main(["analytics", "--out", str(tmp_path)])
    assert len(capsys.readouterr().out.split()) == 3
