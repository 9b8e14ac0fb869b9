"""The port's host-only prepackaged servers (``seldon_core_tpu_torch/servers/
{sklearnserver,xgboostserver,mlflowserver,tfproxy}.py``, ``codec/
tensorproto.py``) held against the JAX package's on the CPU:

- JAX ``tests/test_servers.py``: an SKLEARN_SERVER leaf through the port's
  engine answers as through the JAX engine on the same ``model.joblib``
  (the whole response equal but for the puid), ``method="predict"``
  included; a missing artifact fails at load; xgboost and mlflow, absent
  here, fail cleanly at ``load()`` and at engine build, naming the
  package, as in the JAX package.
- JAX ``tests/test_tfproxy.py``: the port's TensorProto / PredictRequest
  bytes equal the JAX encoder's (float32, float64, int32, int64, negatives
  included) and decode back; REST and gRPC forwarding against a fake TF
  Serving answer as the JAX proxy; an upstream error is the same
  SeldonError (502 ``UPSTREAM_ERROR``), an unknown dtype and a missing
  output too.
"""

import json
import threading
from concurrent import futures
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from seldon_core_tpu.codec import tensorproto as jax_tp
from seldon_core_tpu.contracts.graph import PredictorSpec as JaxSpec
from seldon_core_tpu.contracts.graph import UnitImplementation as JaxImpl
from seldon_core_tpu.contracts.payload import SeldonError as JaxError
from seldon_core_tpu.contracts.payload import SeldonMessage as JaxMessage
from seldon_core_tpu.runtime.engine import GraphEngine as JaxEngine
from seldon_core_tpu.servers import make_prepackaged_server as jax_make_server
from seldon_core_tpu.servers.tfproxy import TFServingProxy as JaxProxy
from seldon_core_tpu_torch.codec import tensorproto as tp
from seldon_core_tpu_torch.contracts.graph import PredictorSpec, UnitImplementation
from seldon_core_tpu_torch.contracts.payload import SeldonError, SeldonMessage
from seldon_core_tpu_torch.runtime.engine import GraphEngine
from seldon_core_tpu_torch.servers import make_prepackaged_server
from seldon_core_tpu_torch.servers.sklearnserver import SKLearnServer
from seldon_core_tpu_torch.servers.tfproxy import TFServingProxy


@pytest.fixture(scope="module")
def sklearn_ckpt(tmp_path_factory):
    import joblib
    from sklearn.linear_model import LogisticRegression

    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 4))
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    d = tmp_path_factory.mktemp("sk")
    joblib.dump(LogisticRegression().fit(X, y), d / "model.joblib")
    return str(d)


def both_engines(graph):
    spec = {"name": "p", "graph": graph}
    return (JaxEngine(JaxSpec.from_dict(spec)),
            GraphEngine(PredictorSpec.from_dict(spec), device="cpu"))


@pytest.mark.parametrize("method", ["predict_proba", "predict"])
def test_sklearn_leaf_answers_as_jax(sklearn_ckpt, method):
    graph = {"name": "clf", "type": "MODEL", "implementation": "SKLEARN_SERVER",
             "modelUri": sklearn_ckpt,
             "parameters": [{"name": "method", "value": method, "type": "STRING"}]}
    j, p = both_engines(graph)
    x = np.random.default_rng(1).normal(size=(5, 4)).round(3)
    body = {"meta": {"puid": "q"},
            "data": {"tensor": {"shape": [5, 4], "values": x.ravel().tolist()}}}
    got_j = j.predict_sync(JaxMessage.from_dict(body)).to_dict()
    got_p = p.predict_sync(SeldonMessage.from_dict(body)).to_dict()
    assert got_p == got_j
    assert got_p["meta"]["requestPath"] == {"clf": "SKLearnServer"}
    direct = p.state.root.component._model
    want = direct.predict_proba(x) if method == "predict_proba" else direct.predict(x)
    np.testing.assert_array_equal(np.asarray(got_p["data"]["tensor"]["values"]).reshape(
        want.shape), want)


def test_sklearn_missing_artifact(tmp_path):
    for make, err in ((make_prepackaged_server, SeldonError), (jax_make_server, JaxError)):
        impl = (UnitImplementation if make is make_prepackaged_server
                else JaxImpl).SKLEARN_SERVER
        with pytest.raises(err, match="model file not found"):
            make(impl, str(tmp_path), {}).load()


def test_sklearn_without_joblib_names_it(monkeypatch, sklearn_ckpt):
    import builtins

    real = builtins.__import__

    def no_joblib(name, *a, **kw):
        if name == "joblib":
            raise ImportError("No module named 'joblib'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_joblib)
    with pytest.raises(SeldonError, match="joblib"):
        SKLearnServer(model_uri=sklearn_ckpt).load()


@pytest.mark.parametrize("impl,package", [("XGBOOST_SERVER", "xgboost"),
                                          ("MLFLOW_SERVER", "mlflow")])
def test_absent_runtime_fails_clean(impl, package, tmp_path):
    try:
        __import__(package)
        pytest.skip(f"{package} is installed here; the absent-runtime path needs it absent")
    except ImportError:
        pass
    server = make_prepackaged_server(UnitImplementation(impl), str(tmp_path), {})
    jserver = jax_make_server(JaxImpl(impl), str(tmp_path), {})
    with pytest.raises(SeldonError, match=package) as e:
        server.load()
    with pytest.raises(JaxError, match=package) as je:
        jserver.load()
    assert (e.value.status_code, e.value.message) == (je.value.status_code, je.value.message)
    graph = {"name": "m", "type": "MODEL", "implementation": impl, "modelUri": str(tmp_path)}
    with pytest.raises(SeldonError, match=package):
        GraphEngine(PredictorSpec.from_dict({"name": "p", "graph": graph}), device="cpu")


# ----------------------------------------------------------- TensorProto
ARRAYS = [np.arange(6, dtype=np.float32).reshape(2, 3) - 2.5,
          np.arange(4, dtype=np.float64).reshape(2, 2) / 3.0,
          np.array([[1, -2, 3], [2 ** 31 - 1, 0, -7]], dtype=np.int32),
          np.array([[1, -2, 3], [2 ** 40, 0, -(2 ** 40)]], dtype=np.int64),
          np.arange(3, dtype=np.float16)]


def tensor_bytes(req: bytes) -> bytes:
    for field, wire, val in tp._iter_fields(req):
        if field == 2 and wire == 2:
            for f2, w2, v2 in tp._iter_fields(val):
                if f2 == 2 and w2 == 2:
                    return v2
    raise AssertionError("no TensorProto in the request")


@pytest.mark.parametrize("i", range(len(ARRAYS)))
def test_tensorproto_bytes_equal_jax(i):
    arr = ARRAYS[i]
    req = tp.encode_predict_request(arr, "m", "sig", "inputs")
    assert req == jax_tp.encode_predict_request(arr, "m", "sig", "inputs")
    got, want = tp.decode_tensor_proto(tensor_bytes(req)), jax_tp.decode_tensor_proto(
        tensor_bytes(req))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    np.testing.assert_array_equal(got, arr.astype(got.dtype))


def test_tensorproto_errors_as_jax():
    buf = tp._tag(1, 0) + tp._varint(7)  # DT_STRING: not decoded here
    with pytest.raises(SeldonError, match="dtype 7") as e:
        tp.decode_tensor_proto(buf)
    with pytest.raises(JaxError) as je:
        jax_tp.decode_tensor_proto(buf)
    assert (e.value.status_code, e.value.message) == (je.value.status_code, je.value.message)
    req = tp.encode_predict_request(np.ones((1, 1), np.float32), "", "", "a")
    (_, _, entry), = [f for f in tp._iter_fields(req) if f[0] == 2]
    resp = b""
    for name in (b"a", b"c"):
        e2 = bytearray(entry)
        e2[2:3] = name
        resp += bytes([0x0A]) + tp._varint(len(e2)) + bytes(e2)
    with pytest.raises(SeldonError, match="missing output"):
        tp.decode_predict_response(resp, "b")
    np.testing.assert_array_equal(tp.decode_predict_response(resp, "c"),
                                  jax_tp.decode_predict_response(resp, "c"))


# --------------------------------------------------------- TF-Serving proxy
def fake_tf_grpc():
    """A gRPC PredictionService/Predict answering 2x + 1 under "scores"."""
    import grpc

    seen = {}

    def predict(request_bytes, context):
        tensor = None
        for field, wire, val in tp._iter_fields(request_bytes):
            if field == 1 and wire == 2:
                for f2, _w, v2 in tp._iter_fields(val):
                    seen[f2] = v2
            elif field == 2 and wire == 2:
                entry = {f2: v2 for f2, _w, v2 in tp._iter_fields(val)}
                seen["input_name"] = entry[1]
                tensor = entry[2]
        out = (2.0 * tp.decode_tensor_proto(tensor) + 1.0).astype(np.float32)
        req = tp.encode_predict_request(out, "", "", "scores")
        entry = [v for f, w, v in tp._iter_fields(req) if f == 2 and w == 2][0]
        return bytes([0x0A]) + tp._varint(len(entry)) + entry

    handler = grpc.method_handlers_generic_handler(
        "tensorflow.serving.PredictionService",
        {"Predict": grpc.unary_unary_rpc_method_handler(
            predict, request_deserializer=lambda b: b, response_serializer=lambda b: b)})
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((handler,))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return server, port, seen


def test_grpc_forwarding_as_jax():
    server, port, seen = fake_tf_grpc()
    try:
        kw = dict(grpc_endpoint=f"127.0.0.1:{port}", model_name="half_plus_two",
                  signature_name="serving_default", model_input="x", model_output="scores")
        X = np.asarray([[1.0, 2.0], [3.0, 4.0]], dtype=np.float32)
        out = TFServingProxy(**kw).predict(X, [])
        np.testing.assert_array_equal(out, JaxProxy(**kw).predict(X, []))
        np.testing.assert_allclose(out, 2.0 * X + 1.0)
        assert (seen[1], seen[3], seen["input_name"]) == (b"half_plus_two",
                                                         b"serving_default", b"x")
    finally:
        server.stop(None)


def test_grpc_upstream_error_as_jax():
    for proxy, err in ((TFServingProxy, SeldonError), (JaxProxy, JaxError)):
        with pytest.raises(err) as e:
            proxy(grpc_endpoint="127.0.0.1:1").predict(np.ones((1, 2), np.float32), [])
        assert (e.value.status_code, e.value.reason) == (502, "UPSTREAM_ERROR")


class _FakeTFRest(BaseHTTPRequestHandler):
    status = 200

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        assert self.path == "/v1/models/model:predict"
        assert body["signature_name"] == "serving_default"
        if self.status == 200:
            resp = json.dumps({"predictions": (np.asarray(body["instances"]) * 3.0).tolist()})
        else:
            resp = "model not loaded"
        resp = resp.encode()
        self.send_response(self.status)
        self.send_header("Content-Length", str(len(resp)))
        self.end_headers()
        self.wfile.write(resp)

    def log_message(self, *a):
        pass


def test_rest_forwarding_and_errors_as_jax():
    httpd = HTTPServer(("127.0.0.1", 0), _FakeTFRest)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    try:
        X = np.asarray([[1.0, 2.0], [0.5, -1.0]])
        out = TFServingProxy(rest_endpoint=url).predict(X, [])
        np.testing.assert_array_equal(out, JaxProxy(rest_endpoint=url).predict(X, []))
        np.testing.assert_allclose(out, X * 3.0)
        _FakeTFRest.status = 503
        for proxy, err in ((TFServingProxy, SeldonError), (JaxProxy, JaxError)):
            with pytest.raises(err) as e:
                proxy(rest_endpoint=url).predict(X, [])
            assert (e.value.status_code, e.value.reason) == (502, "UPSTREAM_ERROR")
            assert "503" in e.value.message and "model not loaded" in e.value.message
    finally:
        _FakeTFRest.status = 200
        httpd.shutdown()
        httpd.server_close()
    # nothing listening: the port's proxy answers 502 too (the JAX one lets
    # requests' ConnectionError through)
    with pytest.raises(SeldonError) as e:
        TFServingProxy(rest_endpoint=url).predict(X, [])
    assert (e.value.status_code, e.value.reason) == (502, "UPSTREAM_ERROR")


def test_tensorflow_server_selected():
    proxy = make_prepackaged_server(UnitImplementation.TENSORFLOW_SERVER, "",
                                    {"rest_endpoint": "http://h:1/", "model_name": "m"})
    assert isinstance(proxy, TFServingProxy) and proxy.rest_endpoint == "http://h:1"
