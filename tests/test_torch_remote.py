"""Remote graph nodes of the port (``seldon_core_tpu_torch/runtime/remote.py``,
``transport/grpc_client.py``) held against the JAX package's on the CPU.

- ``config_from_annotations`` equals the JAX package's on a table of
  annotation dicts, garbage values included; the engine hands its
  annotations to every remote node (JAX ``tests/test_engine.py:289-326``).
- A graph of remote units (a TRANSFORMER over a ROUTER over a COMBINER of
  two MODELs and a third MODEL) over the port's component app (REST) and
  the port's gRPC component server answers as the JAX engine over the JAX
  component app and gRPC server serving the same user component: the whole
  response, meta and the request's puid included, exactly equal (JSON and
  proto carry float32 values exactly). Feedback reaches the same remote nodes with the
  same rewards.
- The hop: remote children fan out concurrently; one keep-alive connection
  with TCP_NODELAY serves sequential calls.
- Failures, status and reason as the JAX package's: retries run out -> 503
  ``REMOTE_NODE_UNAVAILABLE`` after exactly ``retries`` attempts; a spent
  deadline -> 504 with no connection made; a non-200 peer ->
  ``REMOTE_NODE_ERROR`` with its status. A gRPC peer that is down is 503
  (the JAX package lets grpc's error through). ``"frame"`` raises naming
  the native-edge slice.
"""

import asyncio
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
from aiohttp import web

from seldon_core_tpu.components.component import SeldonComponent as JaxComponent
from seldon_core_tpu.contracts.graph import Endpoint as JaxEndpoint
from seldon_core_tpu.contracts.graph import PredictorSpec as JaxSpec
from seldon_core_tpu.contracts.payload import Feedback as JaxFeedback
from seldon_core_tpu.contracts.payload import SeldonError as JaxError
from seldon_core_tpu.contracts.payload import SeldonMessage as JaxMessage
from seldon_core_tpu.runtime import remote as jax_remote
from seldon_core_tpu.runtime.engine import GraphEngine as JaxEngine
from seldon_core_tpu.runtime.resilience import Deadline as JaxDeadline
from seldon_core_tpu.runtime.resilience import deadline_scope as jax_deadline_scope
from seldon_core_tpu.transport.grpc_server import make_component_server as jax_grpc_server
from seldon_core_tpu.transport.rest import make_component_app as jax_component_app
from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.graph import Endpoint, PredictorSpec
from seldon_core_tpu_torch.contracts.payload import Feedback, SeldonError, SeldonMessage
from seldon_core_tpu_torch.runtime import remote
from seldon_core_tpu_torch.runtime.engine import GraphEngine
from seldon_core_tpu_torch.runtime.resilience import Deadline, deadline_scope
from seldon_core_tpu_torch.transport.grpc_server import make_component_server
from seldon_core_tpu_torch.transport.rest import make_component_app, start


def node_class(base):
    """One user component that serves every method, over either package's
    base class; it records the rewards its feedback brings."""

    class Node(base):
        def __init__(self, delay_s: float = 0.0):
            super().__init__()
            self.rewards = []
            self.delay_s = delay_s

        def predict(self, X, names, meta=None):
            time.sleep(self.delay_s)
            return np.asarray(X) * 2.0 + 1.0

        def transform_input(self, X, names, meta=None):
            return np.asarray(X) - 0.5

        def route(self, X, names):
            return int(np.asarray(X).sum() > 0)

        def aggregate(self, Xs, names):
            return np.mean([np.asarray(x) for x in Xs], axis=0)

        def send_feedback(self, X, names, reward, truth, routing=None):
            self.rewards.append(float(reward))

        def tags(self):
            return {"remote": True}

        def metrics(self):
            return [{"type": "COUNTER", "key": "remote_calls", "value": 1}]

    return Node


def start_jax_app(component):
    """The JAX component app (aiohttp) on 127.0.0.1 in a thread: (port, stop)."""
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(jax_component_app(component))
    loop.run_until_complete(runner.setup())
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    site = web.SockSite(runner, sock)
    loop.run_until_complete(site.start())
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def stop():
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(10)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)

    return sock.getsockname()[1], stop


def start_grpc(server_fn, component):
    server = server_fn(component, host="127.0.0.1", port=None)
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return port, lambda: server.stop(None)


@pytest.fixture(scope="module")
def peers():
    """Both packages' user components behind their REST and gRPC servers:
    {"jax" / "port": {"REST" / "GRPC": (component, port)}}."""
    out, stops = {"jax": {}, "port": {}}, []
    for api in ("REST", "GRPC"):
        jcomp, pcomp = node_class(JaxComponent)(), node_class(SeldonComponent)()
        if api == "REST":
            jport, jstop = start_jax_app(jcomp)
            httpd, _ = start(make_component_app(pcomp, device="cpu"))
            pport, pstop = httpd.server_address[1], httpd.shutdown
        else:
            jport, jstop = start_grpc(jax_grpc_server, jcomp)
            pport, pstop = start_grpc(make_component_server, pcomp)
        out["jax"][api], out["port"][api] = (jcomp, jport), (pcomp, pport)
        stops += [jstop, pstop]
    yield out
    for stop in stops:
        stop()


def endpoint(port, api="REST"):
    return {"service_host": "127.0.0.1", "service_port": port, "type": api}


def remote_graph(port, api):
    ep = endpoint(port, api)
    return {"name": "t", "type": "TRANSFORMER", "endpoint": ep, "children": [
        {"name": "r", "type": "ROUTER", "endpoint": ep, "children": [
            {"name": "c", "type": "COMBINER", "endpoint": ep, "children": [
                {"name": "m1", "type": "MODEL", "endpoint": ep},
                {"name": "m2", "type": "MODEL", "endpoint": ep}]},
            {"name": "m3", "type": "MODEL", "endpoint": ep}]}]}


def engines(graph_of, annotations=None):
    """(JAX engine, port engine) over ``graph_of(side)``."""
    j = JaxEngine(JaxSpec.from_dict({"name": "p", "graph": graph_of("jax")}),
                  annotations=annotations)
    p = GraphEngine(PredictorSpec.from_dict({"name": "p", "graph": graph_of("port")}),
                    annotations=annotations, device="cpu")
    return j, p


ANNOTATION_TABLE = [
    {},
    {"seldon.io/rest-read-timeout": "12000", "seldon.io/rest-connection-timeout": "250",
     "seldon.io/rest-connect-retries": "5", "seldon.io/grpc-read-timeout": "7000"},
    {"seldon.io/rest-read-timeout": "soon"},
    {"seldon.io/rest-connect-retries": "0"},
    {"seldon.io/rest-connect-retries": "-4", "seldon.io/grpc-read-timeout": None},
    {"seldon.io/rest-connect-retries": "2.5", "seldon.io/rest-connection-timeout": ""},
    {"seldon.io/wire-format": " FRAME "},
    {"seldon.io/wire-format": "auto"},
    {"seldon.io/wire-format": "protobuf"},
    {"seldon.io/wire-format": ""},
]


@pytest.mark.parametrize("annotations", ANNOTATION_TABLE)
def test_config_from_annotations_matches_jax(annotations):
    assert remote.config_from_annotations(annotations) == \
        jax_remote.config_from_annotations(annotations)


def test_annotations_tune_remote_nodes():
    ann = {"seldon.io/rest-connect-retries": "2", "seldon.io/rest-read-timeout": "1000"}
    rc = remote.RemoteComponent(Endpoint(service_host="h", service_port=1, type="REST"),
                                annotations=ann)
    jrc = jax_remote.RemoteComponent(JaxEndpoint(service_host="h", service_port=1, type="REST"),
                                     annotations=ann)
    assert (rc.retries, rc.timeout_s, rc.grpc_timeout_s) == \
        (jrc.retries, jrc.timeout_s, jrc.grpc_timeout_s) == (2, 1.0, 5.0)
    # the engine hands its annotations to every remote node
    graph = {"name": "r", "type": "MODEL", "endpoint": endpoint(59999)}
    ann = {"seldon.io/rest-connect-retries": "1", "seldon.io/rest-read-timeout": "1500"}
    j, p = engines(lambda side: graph, annotations=ann)
    pc, jc = p.state.root.component, j.state.root.component
    assert (pc.retries, pc.timeout_s) == (jc.retries, jc.timeout_s) == (1, 1.5)
    assert p.has_async_nodes and p.state.root.image == "RemoteComponent"


@pytest.mark.parametrize("wire", ["frame", "auto"])
def test_frame_wire_format_names_the_native_edge_slice(wire):
    ep = Endpoint(service_host="h", service_port=1, type="REST")
    with pytest.raises(NotImplementedError, match="native-edge slice"):
        remote.RemoteComponent(ep, wire_format=wire)
    with pytest.raises(NotImplementedError, match="native-edge slice"):
        remote.RemoteComponent(ep, annotations={"seldon.io/wire-format": wire})
    with pytest.raises(ValueError, match="wire_format"):
        remote.RemoteComponent(ep, wire_format="protobuf")


@pytest.mark.parametrize("api", ["REST", "GRPC"])
def test_remote_graph_answers_as_jax(peers, api):
    j, p = engines(lambda side: remote_graph(peers[side][api][1], api))
    for seed, shape in ((0, (2, 3)), (1, (1, 4)), (2, (3, 2))):
        x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
        for sign in (1.0, -1.0):  # both branches of the remote router
            body = {"meta": {"puid": f"req-{seed}"},
                    "data": {"tensor": {"shape": list(shape),
                                        "values": (sign * np.abs(x) + sign).ravel().tolist()}}}
            got_j = j.predict_sync(JaxMessage.from_dict(body)).to_dict()
            got_p = p.predict_sync(SeldonMessage.from_dict(body)).to_dict()
            assert got_p == got_j  # exact: float32 values round-trip JSON and proto
            assert got_p["meta"]["puid"] == f"req-{seed}"
    # feedback replays down the routed branch to the same remote nodes
    jcomp, pcomp = peers["jax"][api][0], peers["port"][api][0]
    before = (len(jcomp.rewards), len(pcomp.rewards))
    body = {"data": {"tensor": {"shape": [1, 2], "values": [3.0, 4.0]}}}
    for reward in (1.0, 0.25):
        jresp = j.predict_sync(JaxMessage.from_dict(body))
        presp = p.predict_sync(SeldonMessage.from_dict(body))
        assert presp.meta.routing == jresp.meta.routing == {"r": 1}
        j.send_feedback_sync(JaxFeedback(request=JaxMessage.from_dict(body), response=jresp,
                                         reward=reward))
        p.send_feedback_sync(Feedback(request=SeldonMessage.from_dict(body), response=presp,
                                      reward=reward))
    assert jcomp.rewards[before[0]:] == pcomp.rewards[before[1]:]
    assert len(pcomp.rewards) - before[1] == 2 * 2  # the router and m3, twice


def test_remote_children_fan_out_concurrently():
    comp = node_class(SeldonComponent)(delay_s=0.4)
    httpd, _ = start(make_component_app(comp, device="cpu"))
    try:
        ep = endpoint(httpd.server_address[1])
        graph = {"name": "c", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
                 "children": [{"name": f"m{i}", "type": "MODEL", "endpoint": ep}
                              for i in range(3)]}
        p = GraphEngine(PredictorSpec.from_dict({"name": "p", "graph": graph}), device="cpu")
        body = {"data": {"tensor": {"shape": [1, 1], "values": [1.0]}}}
        p.predict_sync(SeldonMessage.from_dict(body))  # connections opened
        t0 = time.perf_counter()
        out = p.predict_sync(SeldonMessage.from_dict(body))
        wall = time.perf_counter() - t0
        assert out.data.to_numpy().tolist() == [[3.0]]
        assert wall < 2 * 0.4, wall  # three 0.4 s children, not in series
    finally:
        httpd.shutdown()


class _Echo(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    peers: list = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.peers.append(self.client_address)
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_one_keepalive_connection_with_nodelay():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Echo)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    _Echo.peers = []
    try:
        rc = remote.RemoteComponent(Endpoint(service_host="127.0.0.1",
                                             service_port=httpd.server_address[1]))
        msg = SeldonMessage.from_dict({"data": {"ndarray": [[1.0, 2.0]]}})
        for _ in range(6):
            out = asyncio.run(rc.predict_raw(msg))
            assert out.data.to_numpy().tolist() == [[1.0, 2.0]]
        assert len(_Echo.peers) == 6 and len(set(_Echo.peers)) == 1
        (conn,) = rc._pool._idle
        assert conn.sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY) != 0
        rc.close()
    finally:
        httpd.shutdown()


class _Listener:
    """A listening socket that counts the connections it accepts and closes
    each at once (``reply=False``: never accepts, so none completes)."""

    def __init__(self, close_each: bool = True):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        self.accepted = 0
        if close_each:
            threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.accepted += 1
            conn.close()

    def close(self):
        self.sock.close()


def _errors(j, p, body, jax_scope=None, port_scope=None):
    """(JAX error, port error) of one request through each engine."""
    with pytest.raises(JaxError) as je:
        with jax_scope() if jax_scope else _null():
            j.predict_sync(JaxMessage.from_dict(body))
    with pytest.raises(SeldonError) as pe:
        with port_scope() if port_scope else _null():
            p.predict_sync(SeldonMessage.from_dict(body))
    return je.value, pe.value


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


BODY = {"data": {"tensor": {"shape": [1, 1], "values": [1.0]}}}


def test_retries_run_out_503():
    listener = _Listener()
    try:
        graph = {"name": "m", "type": "MODEL", "endpoint": endpoint(listener.port)}
        j, p = engines(lambda side: graph)
        t0 = time.perf_counter()
        with pytest.raises(SeldonError) as pe:
            p.predict_sync(SeldonMessage.from_dict(BODY))
        wall = time.perf_counter() - t0
        assert listener.accepted == remote.DEFAULT_RETRIES == 3
        assert 0.05 + 0.1 <= wall < 2.0  # the two backoffs between three attempts
        with pytest.raises(JaxError) as je:
            j.predict_sync(JaxMessage.from_dict(BODY))
        assert (pe.value.status_code, pe.value.reason) == \
            (je.value.status_code, je.value.reason) == (503, "REMOTE_NODE_UNAVAILABLE")
    finally:
        listener.close()
    # a closed port: the same answer
    closed = socket.socket()
    closed.bind(("127.0.0.1", 0))
    port = closed.getsockname()[1]
    closed.close()
    graph = {"name": "m", "type": "MODEL", "endpoint": endpoint(port)}
    j, p = engines(lambda side: graph,
                   annotations={"seldon.io/rest-connect-retries": "2"})
    je, pe = _errors(j, p, BODY)
    assert (pe.status_code, pe.reason) == (je.status_code, je.reason) == \
        (503, "REMOTE_NODE_UNAVAILABLE")
    assert "after 2 attempts" in pe.message


def test_spent_deadline_504_without_a_connection():
    listener = _Listener(close_each=False)  # listens, never accepts or replies
    try:
        graph = {"name": "m", "type": "MODEL", "endpoint": endpoint(listener.port)}
        j, p = engines(lambda side: graph)

        def spent(deadline_cls, scope):
            d = deadline_cls(0.001)
            time.sleep(0.01)
            return lambda: scope(d)

        je, pe = _errors(j, p, BODY, jax_scope=spent(JaxDeadline, jax_deadline_scope),
                         port_scope=spent(Deadline, deadline_scope))
        assert (pe.status_code, pe.reason) == (je.status_code, je.reason) == \
            (504, "DEADLINE_EXCEEDED")
        listener.sock.settimeout(0.2)
        with pytest.raises(socket.timeout):
            listener.sock.accept()  # no connection was ever made
    finally:
        listener.close()


def test_peer_error_status_passes_through(peers):
    """A remote node answering non-200 surfaces as REMOTE_NODE_ERROR with the
    peer's status, not retried."""

    class Bad:
        def predict(self, X, names, meta=None):
            raise ValueError("bad input")

    def bad_class(base):
        return type("Bad", (Bad, base), {})

    jport, jstop = start_jax_app(bad_class(JaxComponent)())
    httpd, _ = start(make_component_app(bad_class(SeldonComponent)(), device="cpu"))
    try:
        j, p = engines(lambda side: {"name": "m", "type": "MODEL", "endpoint": endpoint(
            jport if side == "jax" else httpd.server_address[1])})
        je, pe = _errors(j, p, BODY)
        assert (pe.status_code, pe.reason) == (je.status_code, je.reason)
        assert pe.reason == "REMOTE_NODE_ERROR" and pe.status_code >= 400
    finally:
        jstop()
        httpd.shutdown()


def test_grpc_peer_down_is_503():
    closed = socket.socket()
    closed.bind(("127.0.0.1", 0))
    port = closed.getsockname()[1]
    closed.close()
    p = GraphEngine(PredictorSpec.from_dict(
        {"name": "p", "graph": {"name": "m", "type": "MODEL", "endpoint": endpoint(port, "GRPC")}}),
        annotations={"seldon.io/grpc-read-timeout": "2000"}, device="cpu")
    with pytest.raises(SeldonError) as e:
        p.predict_sync(SeldonMessage.from_dict(BODY))
    assert (e.value.status_code, e.value.reason) in ((503, "REMOTE_NODE_UNAVAILABLE"),
                                                     (504, "DEADLINE_EXCEEDED"))
