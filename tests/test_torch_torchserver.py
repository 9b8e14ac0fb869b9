"""One-model predict in the port (TorchServer, its checkpoint reader and
writer, the REST predict routes, the CLI) held against the JAX package's
JAXServer on the CPU.

The checkpoint is a folded ResNet-18 at 32x32 with 10 classes whose
BatchNorm statistics were redrawn before folding (live residual branches),
written by the JAX package's ``export_checkpoint(use_orbax=False)``. Logits
are held to FWD_TOL of max|logit| (bf16 convolutions rounded in different
orders), top-1 equal but for near-ties; names, meta and status codes
exactly."""

import json
import os
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from seldon_core_tpu.codec.response import construct_response as jax_construct
from seldon_core_tpu.codec.staging import bucket_size as jax_bucket_size
from seldon_core_tpu.codec.staging import pad_batch as jax_pad_batch
from seldon_core_tpu.contracts.parameters import parse_parameters as jax_parse_parameters
from seldon_core_tpu.contracts.payload import SeldonMessage as JaxMessage
from seldon_core_tpu.models import get_model as jax_get_model
from seldon_core_tpu.models.resnet import fold_batchnorm as jax_fold_batchnorm
from seldon_core_tpu.servers.jaxserver import JAXServer
from seldon_core_tpu.servers.jaxserver import export_checkpoint as jax_export
from seldon_core_tpu_torch import storage
from seldon_core_tpu_torch.codec.staging import bucket_size, pad_batch, stage_to_device
from seldon_core_tpu_torch.contracts.graph import UnitImplementation
from seldon_core_tpu_torch.contracts.parameters import parse_parameters
from seldon_core_tpu_torch.contracts.payload import SeldonError
from seldon_core_tpu_torch.models import checkpoint
from seldon_core_tpu_torch.servers import make_prepackaged_server
from seldon_core_tpu_torch.servers.torchserver import TorchServer, export_checkpoint
from seldon_core_tpu_torch.transport.cli import build_component
from seldon_core_tpu_torch.transport.rest import make_component_app, start

FWD_TOL = 0.03
KW = {"num_classes": 10, "fused": True}


def _live(variables, seed=0):
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, variables)

    def walk(p, s):
        for k in sorted(p):
            if isinstance(p[k], dict) and "scale" in p[k]:
                n = p[k]["scale"].shape
                p[k] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                        "bias": rng.normal(0, 0.1, n).astype(np.float32)}
                s[k] = {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])

    walk(tree["params"], tree["batch_stats"])
    return tree


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A JAX-written checkpoint, the JAXServer serving it, and its logits."""
    init_model = jax_get_model("resnet18", num_classes=10)
    raw = jax.jit(init_model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    folded = jax.tree.map(np.asarray, jax_fold_batchnorm(_live(raw)))
    assert all(np.abs(folded["params"][f"BottleneckBlock_{i}"]["Conv_2"]["kernel"]).max() > 0
               for i in range(8))
    path = str(tmp_path_factory.mktemp("resnet18-ckpt"))
    jax_export(path, "resnet18", folded, kwargs=KW, input_shape=[32, 32, 3], use_orbax=False)
    jserver = JAXServer(model_uri=path)
    jserver.load()
    x = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    return dict(path=path, folded=folded, jserver=jserver, x=x, want=jserver.predict(x, []))


@pytest.fixture(scope="module")
def server(ckpt):
    s = TorchServer(model_uri=ckpt["path"], device="cpu")
    s.load()
    return s


def check_logits(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    bound = FWD_TOL * np.abs(ref).max()
    assert np.abs(got - ref).max() <= bound
    top2 = np.sort(ref, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > bound
    assert np.all((got.argmax(-1) == ref.argmax(-1))[clear])


def test_jax_checkpoint_serves_like_jaxserver(ckpt, server):
    got = server.predict(ckpt["x"], [])
    assert got.dtype == np.float32 and got.shape == (3, 10)
    check_logits(got, ckpt["want"])
    assert server.input_dtype == ckpt["jserver"].input_dtype
    assert server.class_names() == ckpt["jserver"].class_names()
    # a bucket-padded batch (3 -> 4) gives the same rows as one image alone
    check_logits(server.predict(ckpt["x"][:1], []), got[:1])


def test_port_writer_is_read_by_flax(ckpt, tmp_path):
    tree = {"params": ckpt["folded"]["params"],
            "extra": {"bf16": torch.tensor([1.5, -2.0, 3.25]).to(torch.bfloat16),
                      "scalar": np.float32(2.5), "i": np.int32(-7), "n": 3, "f": 0.25,
                      "s": "text", "b": b"\x00\x01", "empty": np.zeros((0, 4), np.float32)}}
    restored = flax.serialization.msgpack_restore(checkpoint.dumps(tree))
    np.testing.assert_array_equal(restored["params"]["head"]["kernel"],
                                  ckpt["folded"]["params"]["head"]["kernel"])
    extra = restored["extra"]
    assert extra["bf16"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(extra["bf16"], np.float32), [1.5, -2.0, 3.25])
    assert extra["scalar"] == np.float32(2.5) and extra["i"] == -7
    assert (extra["n"], extra["f"], extra["s"], extra["b"]) == (3, 0.25, "text", b"\x00\x01")
    assert extra["empty"].shape == (0, 4)
    # and the port reads its own output back
    back = checkpoint.loads(checkpoint.dumps(tree))
    assert back["extra"]["bf16"].dtype == torch.bfloat16
    assert torch.equal(back["extra"]["bf16"], tree["extra"]["bf16"])
    # a port-written checkpoint serves in JAXServer and TorchServer alike
    m = TorchServer(model_uri=ckpt["path"], device="cpu")
    m.load()
    out = str(tmp_path / "port-ckpt")
    export_checkpoint(out, "resnet18", {"params": m._module.param_tree()}, kwargs=KW,
                      input_shape=[32, 32, 3])
    jserver = JAXServer(model_uri=out)
    jserver.load()
    check_logits(jserver.predict(ckpt["x"], []), ckpt["want"])


def test_reader_takes_flax_bf16_and_scalar_leaves():
    tree = {"a": jnp.asarray([[1.0, -0.5]], jnp.bfloat16), "s": np.float32(4.0),
            "h": np.float16(1.5), "i": np.int64(2 ** 40), "v": np.arange(5, dtype=np.int8)}
    got = checkpoint.loads(flax.serialization.to_bytes(tree))
    assert got["a"].dtype == torch.bfloat16 and got["a"].shape == (1, 2)
    assert got["a"].float().tolist() == [[1.0, -0.5]]
    assert got["s"] == np.float32(4.0) and got["h"] == np.float16(1.5)
    assert got["i"] == 2 ** 40
    np.testing.assert_array_equal(got["v"], np.arange(5, dtype=np.int8))


def test_chunked_leaf_and_orbax_dir_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 16)
    blob = flax.serialization.to_bytes({"params": {"big": np.zeros(64, np.float32)}})
    with pytest.raises(SeldonError, match="params.big"):
        checkpoint.loads(blob)
    d = tmp_path / "orbax"
    (d / "params").mkdir(parents=True)
    (d / "config.json").write_text(json.dumps({"model": "resnet18", "kwargs": KW}))
    with pytest.raises(SeldonError, match="orbax") as e:
        TorchServer(model_uri=str(d), device="cpu").load()
    assert e.value.status_code == 500


def _post(url, body: bytes, ctype="application/json", method="POST"):
    req = urllib.request.Request(url, data=body if method == "POST" else None, method=method,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def rest(server):
    httpd, _ = start(make_component_app(server, device="cpu"))
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def _jax_response(ckpt, body):
    req = JaxMessage.from_dict(body)
    return jax_construct(ckpt["jserver"], False, req,
                         ckpt["jserver"].predict(req.payload(), req.names)).to_dict()


def _same_structure(got, want):
    """Equal JSON but for the logits, which are held to the tolerance."""
    data_g, data_w = got.pop("data"), want.pop("data")
    assert got == want  # meta (puid echoed), no status
    assert data_g["names"] == data_w["names"] == [f"t:{i}" for i in range(10)]
    enc = "tensor" if "tensor" in data_w else "ndarray"
    assert set(data_g) == set(data_w) == {"names", enc}
    if enc == "tensor":
        assert data_g["tensor"]["shape"] == data_w["tensor"]["shape"]
        g = np.asarray(data_g["tensor"]["values"]).reshape(data_g["tensor"]["shape"])
        w = np.asarray(data_w["tensor"]["values"]).reshape(data_w["tensor"]["shape"])
    else:
        g, w = np.asarray(data_g["ndarray"]), np.asarray(data_w["ndarray"])
    check_logits(g, w)


@pytest.mark.parametrize("route", ["/predict", "/api/v0.1/predictions"])
@pytest.mark.parametrize("enc", ["tensor", "ndarray"])
def test_rest_predict_matches_jax_response(ckpt, rest, route, enc):
    x = ckpt["x"][:2]
    data = ({"tensor": {"shape": list(x.shape), "values": x.ravel().tolist()}}
            if enc == "tensor" else {"ndarray": x.tolist()})
    body = {"meta": {"puid": f"puid-{enc}"}, "data": data}
    code, got = _post(rest + route, json.dumps(body).encode())
    assert code == 200
    _same_structure(got, _jax_response(ckpt, body))


def test_rest_predict_body_forms(ckpt, rest):
    """Form field json= and query ?json= (GET), as the JAX package parses
    (values rounded so the query stays under the request-line limit)."""
    x = np.round(ckpt["x"][:1].astype(np.float64), 1)
    body = {"data": {"ndarray": x.tolist()}}
    want = _jax_response(ckpt, body)
    form = urllib.parse.urlencode({"json": json.dumps(body)}).encode()
    code, got = _post(rest + "/api/v0.1/predictions", form, "application/x-www-form-urlencoded")
    assert code == 200
    _same_structure(got, dict(want))
    q = urllib.parse.urlencode({"json": json.dumps(body)})
    code, got = _post(f"{rest}/predict?{q}", b"", method="GET")
    assert code == 200
    _same_structure(got, _jax_response(ckpt, body))


@pytest.mark.parametrize("body,ctype,code", [
    (b"{not json", "application/json", 400),
    (b'{"data": {"tftensor": {}}}', "application/json", 400),
    (b'{"data": {"tensor": {"shape": [2], "values": [1]}}}', "application/json", 400),
    # a part without a name: aiohttp's ValueError, 500 in the JAX app too
    (b"--x\r\n", "multipart/form-data; boundary=x", 500),
    (b"\x00", "application/x-seldon-frame", 501),
])
def test_rest_predict_errors_carry_a_status(rest, body, ctype, code):
    got_code, got = _post(rest + "/api/v0.1/predictions", body, ctype)
    assert got_code == code
    assert got["status"]["code"] == code and got["status"]["status"] == "FAILURE"


def _multipart(fields, boundary="bnd"):
    """A multipart/form-data body: (name, value, filename or None) parts."""
    out = b""
    for name, value, filename in fields:
        disp = f'form-data; name="{name}"' + (f'; filename="{filename}"' if filename else "")
        out += (f"--{boundary}\r\nContent-Disposition: {disp}\r\n"
                f"Content-Type: application/octet-stream\r\n\r\n").encode() + value + b"\r\n"
    return out + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def test_rest_multipart_predict_matches_jax_app(ckpt, rest):
    """A multipart predict (its data and meta as form fields, or as file
    parts) is served as its JSON body would be, and the JAX app reads the
    same bytes to the same answer."""
    import asyncio
    import socket

    from aiohttp import web

    from seldon_core_tpu.transport.rest import make_component_app as jax_component_app

    x = np.round(ckpt["x"][:2].astype(np.float64), 3)
    data = json.dumps({"ndarray": x.tolist()}).encode()
    meta = json.dumps({"puid": "multipart"}).encode()
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(jax_component_app(ckpt["jserver"]))
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    loop.run_until_complete(runner.setup())
    loop.run_until_complete(web.SockSite(runner, sock).start())
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        for files in (False, True):
            body, ctype = _multipart([("data", data, "d.json" if files else None),
                                      ("meta", meta, "m.json" if files else None)])
            code, got = _post(rest + "/api/v0.1/predictions", body, ctype)
            assert code == 200
            want = _jax_response(ckpt, {"data": {"ndarray": x.tolist()},
                                        "meta": {"puid": "multipart"}})
            _same_structure(dict(got), dict(want))
            jcode, jgot = _post(f"http://127.0.0.1:{sock.getsockname()[1]}/api/v0.1/predictions",
                                body, ctype)
            assert jcode == 200
            _same_structure(got, jgot)
        # a strData file part reaches the model as text, which it refuses
        body, ctype = _multipart([("strData", b"text", "s.txt")])
        code, got = _post(rest + "/predict", body, ctype)
        jcode, jgot = _post(f"http://127.0.0.1:{sock.getsockname()[1]}/predict", body, ctype)
        assert code == jcode == 500 and got == jgot
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)


def test_missing_config_answers_500(tmp_path):
    s = TorchServer(model_uri=str(tmp_path), device="cpu")
    httpd, _ = start(make_component_app(s, device="cpu"))
    try:
        code, got = _post(f"http://127.0.0.1:{httpd.server_address[1]}/predict",
                          json.dumps({"data": {"ndarray": [[1.0]]}}).encode())
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert code == 500
    assert "config.json" in got["status"]["info"] and got["status"]["status"] == "FAILURE"


def test_cli_builds_server_from_unit_parameters(ckpt, monkeypatch):
    params = [{"name": "model_uri", "value": ckpt["path"], "type": "STRING"},
              {"name": "batch_buckets", "value": "[1, 4]", "type": "STRING"}]
    monkeypatch.setenv("PREDICTIVE_UNIT_PARAMETERS", json.dumps(params[:1]))
    assert parse_parameters() == jax_parse_parameters()
    comp = build_component("seldon_core_tpu_torch.servers.torchserver.TorchServer", "cpu")
    assert isinstance(comp, TorchServer) and comp.ready and comp.device.type == "cpu"
    check_logits(comp.predict(ckpt["x"], []), ckpt["want"])


def test_prepackaged_and_later_slice_knobs(ckpt):
    s = make_prepackaged_server(UnitImplementation.JAX_SERVER, ckpt["path"], device="cpu")
    assert isinstance(s, TorchServer) and s.model_uri == ckpt["path"]
    # SKLEARN_SERVER is served now: a checkpoint without model.joblib fails
    # its load, naming the missing file
    with pytest.raises(SeldonError, match="model.joblib"):
        make_prepackaged_server(UnitImplementation.SKLEARN_SERVER, ckpt["path"]).load()
    # the int8 and param-dtype knobs serve as JAXServer's do (the cast
    # first, then int8): the folded ResNet's conv kernels and head held as
    # int8, every identity chain still through K3's wrapper on bf16
    # weights and float32 biases (cast to bf16 and back: exact)
    knob = dict(param_dtype="auto", quantize="int8")
    port = TorchServer(model_uri=ckpt["path"], device="cpu", **knob)
    check_logits(port.predict(ckpt["x"], []),
                 JAXServer(model_uri=ckpt["path"], **knob).predict(ckpt["x"], []))
    k3 = port._module.serving_operands("cpu")["blocks"][1]["k3"]
    assert k3["w2"].q.dtype == torch.int8 and k3["w2"].orig_dtype == torch.bfloat16
    assert all(k3[b].dtype == torch.float32 for b in ("b1", "b2", "b3"))
    # a mesh over ranks on distinct devices raises at load(), naming
    # two-card meshes (co-located meshes: tests/test_torch_tensor_parallel.py)
    from seldon_core_tpu_torch.parallel.topology import Topology

    two = Topology(devices=["cpu", "meta"])
    for knob in (dict(tensor_parallel=2, topology=two), dict(mesh=two.serving_mesh(2))):
        s = TorchServer(model_uri=ckpt["path"], device="cpu", **knob)
        with pytest.raises(NotImplementedError, match="Queue A 9b"):
            s.load()
        assert not s.ready
    with pytest.raises(NotImplementedError, match="orbax"):
        export_checkpoint("/unused", "resnet18", {}, use_orbax=True)


def test_concurrent_predicts_match_a_lone_predict(ckpt, server):
    """Concurrent predicts share the loaded module and its cached serving
    operands; each result equals a lone predict."""
    want = server.predict(ckpt["x"], [])
    outs = [None] * 4

    def run(i):
        outs[i] = server.predict(ckpt["x"], [])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    for o in outs:
        np.testing.assert_array_equal(o, want)


def test_storage_and_staging(tmp_path):
    (tmp_path / "m").mkdir()
    (tmp_path / "m" / "f.txt").write_text("x")
    assert storage.download(str(tmp_path / "m")) == str(tmp_path / "m")
    assert storage.download(f"file://{tmp_path}/m") == str(tmp_path / "m")
    copied = storage.download(str(tmp_path / "m"), out_dir=str(tmp_path / "out"))
    assert os.path.exists(os.path.join(copied, "f.txt"))
    with pytest.raises(storage.StorageError, match="boto3"):
        storage.download("s3://bucket/model")
    with pytest.raises(storage.StorageError, match="does not exist"):
        storage.download(str(tmp_path / "missing"))
    for n in (1, 3, 8, 1000, 1500):
        assert bucket_size(n) == jax_bucket_size(n)
    arr = np.ones((3, 2), np.float32)
    padded, n = pad_batch(arr)
    jpadded, jn = jax_pad_batch(arr)
    np.testing.assert_array_equal(padded, jpadded)
    assert n == jn == 3
    t, n = stage_to_device(arr, "cpu", pad=True)
    assert isinstance(t, torch.Tensor) and tuple(t.shape) == (4, 2) and n == 3


@pytest.fixture(scope="module")
def unfolded_ckpt(tmp_path_factory):
    """An unfolded ResNet-18 checkpoint (params and live batch_stats, the
    registry's default fused=False) written by the JAX package."""
    init_model = jax_get_model("resnet18", num_classes=10)
    raw = jax.jit(init_model.init)(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))
    path = str(tmp_path_factory.mktemp("resnet18-unfolded"))
    jax_export(path, "resnet18", _live(raw), kwargs={"num_classes": 10},
               input_shape=[32, 32, 3], use_orbax=False)
    return path


@pytest.mark.parametrize("knob", [dict(quantize="int8"), dict(param_dtype="auto"),
                                  dict(param_dtype="auto", quantize="int8")],
                         ids=["int8", "auto", "auto-int8"])
def test_unfolded_resnet_knobs_match_jaxserver(ckpt, unfolded_ckpt, knob):
    """The int8 and param-dtype knobs on an unfolded ResNet (BatchNorm kept,
    its conv kernels and head quantized): the port's logits equal
    JAXServer's within FWD_TOL of max|logit|."""
    x = ckpt["x"]
    port = TorchServer(model_uri=unfolded_ckpt, device="cpu", **knob)
    check_logits(port.predict(x, []), JAXServer(model_uri=unfolded_ckpt, **knob).predict(x, []))
    if "quantize" in knob:
        assert port._module.conv_init.kernel.q.dtype == torch.int8
        assert port._module.head.kernel.q.dtype == torch.int8


@pytest.mark.parametrize("knob", [dict(quantize="int8"), dict(param_dtype="auto"),
                                  dict(param_dtype="bfloat16", quantize="int8")],
                         ids=["int8", "auto", "bf16-int8"])
def test_transformer_checkpoint_knobs_match_jaxserver(tmp_path, knob):
    """A transformer checkpoint through both servers' int8 and param-dtype
    knobs (the port's ``Transformer.quantize_`` layout): logits within
    1e-5 of max|logit| in float32, FWD_TOL once the weights are bf16."""
    model = jax_get_model("llama-tiny")
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))
    path = str(tmp_path / "llm")
    jax_export(path, model="llama-tiny", params=variables, input_shape=[8], input_dtype="int32",
               use_orbax=False)
    x = np.random.default_rng(3).integers(0, 256, size=(3, 8))
    want = JAXServer(model_uri=path, **knob).predict(x, [])
    got = TorchServer(model_uri=path, device="cpu", **knob).predict(x, [])
    tol = FWD_TOL if knob.get("param_dtype") == "bfloat16" else 1e-5
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
