"""The port's gRPC component server (``seldon_core_tpu_torch/transport/
grpc_server.py``) against the JAX package's, on the CPU, with the JAX
package's ``grpc_client`` as the client of both:

- ``Model/GenerateStream`` events equal the JAX server's and the port's own
  SSE events, for a text and an id prompt, and with speculation on (n-gram,
  the perfect drafter) they equal SSE's and the done tokens; its rejections before the
  stream (a per-request temperature, a seeded prompt the slot cache cannot
  hold) are INVALID_ARGUMENT with JAX's message; a page shed and a tenant's
  quota shed are RESOURCE_EXHAUSTED, an unknown class INVALID_ARGUMENT;
- ``Model/Predict`` gives JAX's payload for an LLM prompt (it joins the
  batch) and for a tiny host model, and a ``TorchServer`` answers as over
  REST;
- the transform, route, aggregate and feedback rpcs answer the JAX
  component server's replies; ``DebugTimeline`` answers the component app's
  ``/debug/timeline`` payload; the max-message-size annotation is honoured;
- the CLI's GRPC api serves with the annotations file's max message size,
  and without grpcio it exits naming the module."""

import json
import sys
import urllib.request

import numpy as np
import pytest
import torch

import grpc
import jax

from seldon_core_tpu.contracts.payload import Feedback, SeldonMessage, SeldonMessageList
from seldon_core_tpu.servers.llmserver import LLMServer as JaxLLMServer
from seldon_core_tpu.transport import grpc_client
from seldon_core_tpu.transport.grpc_server import make_component_server as jax_server
from seldon_core_tpu_torch.servers.llmserver import LLMServer
from seldon_core_tpu_torch.transport.grpc_server import (ANNOTATION_GRPC_MAX_MSG_SIZE,
                                                         make_component_server)
from seldon_core_tpu_torch.transport.rest import make_component_app, start

KW = dict(vocab_size=256, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=64,
          max_seq_len=64, dtype="float32")
COMMON = dict(model="transformer", model_kwargs=KW, max_new_tokens=6, len_buckets=(16,),
              batch_buckets=(1, 4), temperature=0.0, eos_id=-1, seed=3, continuous_batching=2)
IDS = [5, 9, 17, 2, 40, 3, 22, 8, 11, 60, 2, 33]
TIMEOUT = 60.0


def served(server_fn, component, **kw):
    """(target, server) of a started gRPC server for ``component``."""
    server = server_fn(component, host="127.0.0.1", port=None, **kw)
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return f"127.0.0.1:{port}", server


def stream(target, body, metadata=None):
    return [m.json_data for m in grpc_client.call_stream(
        target, "GenerateStream", SeldonMessage.from_dict({"jsonData": body}),
        timeout_s=TIMEOUT, metadata=metadata)]


def sse(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate",
                                 data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return [json.loads(line[6:]) for line in (raw.decode().strip() for raw in r)
                if line.startswith("data: ")]


@pytest.fixture(scope="module")
def servers():
    """(JAX target, port target, port REST port, port server): the JAX
    LLMServer and its port twin (the same weights), each behind its gRPC
    server, and the port's REST app on the same server."""
    j = JaxLLMServer(init_random=True, **COMMON)
    j.load()
    p = LLMServer(device="cpu", **COMMON)
    p.load(params={"params": jax.tree_util.tree_map(np.asarray, j._params["params"])})
    jtarget, jsrv = served(jax_server, j)
    ptarget, psrv = served(make_component_server, p)
    httpd, _ = start(make_component_app(p, device="cpu"))
    try:
        yield jtarget, ptarget, httpd.server_address[1], p
    finally:
        jsrv.stop(None)
        psrv.stop(None)
        httpd.shutdown()
        httpd.server_close()
        if getattr(p, "_batcher_service", None) is not None:
            p._batcher_service.close()


@pytest.mark.parametrize("body", [{"prompt": "hello world"},
                                  {"prompt": IDS, "max_new_tokens": 9}], ids=["text", "ids"])
def test_generate_stream_equals_jax_and_sse(servers, body):
    jtarget, ptarget, rest_port, _ = servers
    got = stream(ptarget, body)
    assert got == stream(jtarget, body)
    assert got == sse(rest_port, body)
    assert got[-1]["done"] is True
    assert [e["token"] for e in got[:-1]] == got[-1]["tokens"]
    assert len(got[-1]["tokens"]) == body.get("max_new_tokens", COMMON["max_new_tokens"])


@pytest.mark.parametrize("body", [{"prompt": "hello", "temperature": 0.5},
                                  {"prompt": "x" * 40, "seed": 9}],
                         ids=["temperature", "seeded oversized"])
def test_stream_rejections_equal_jax(servers, body):
    jtarget, ptarget, _, _ = servers
    errors = []
    for target in (ptarget, jtarget):
        with pytest.raises(grpc.RpcError) as e:
            stream(target, body)
        errors.append((e.value.code(), e.value.details()))
    assert errors[0] == errors[1]
    assert errors[0][0] == grpc.StatusCode.INVALID_ARGUMENT


def test_stream_status_mapping(servers, monkeypatch):
    """A page-exhaustion shed is RESOURCE_EXHAUSTED; so is a tenant over its
    quota (one of its requests queued while admission is held); an unknown
    class is INVALID_ARGUMENT."""
    import threading

    from seldon_core_tpu_torch.runtime.batcher import get_batcher_service

    _, ptarget, _, server = servers
    batcher = get_batcher_service(server).batcher
    held = batcher._allocator.alloc(batcher._allocator.free_count())
    try:
        with pytest.raises(grpc.RpcError) as e:
            stream(ptarget, {"prompt": "hello"})
        assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
    finally:
        batcher._allocator.free(held)
    monkeypatch.setitem(batcher._pending._tenant_quotas, "acme", 1)
    gate, admit = threading.Event(), batcher._admit_pending
    monkeypatch.setattr(batcher, "_admit_pending", lambda: (gate.wait(), admit()))
    try:
        queued = server._batcher_service.submit(IDS, 4, tenant="acme")
        with pytest.raises(grpc.RpcError) as e:
            stream(ptarget, {"prompt": "hello"}, [("seldon-tenant", "acme")])
        assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        assert "over its admission quota" in e.value.details()
    finally:
        gate.set()
    # its solo tokens, through the batch (no private generate(): the Predict
    # test reads that count)
    assert queued.result(TIMEOUT) == server._batcher_service.submit_sync(IDS, 4)
    for metadata, code, text in (
            ([("seldon-slo-class", "gold")], grpc.StatusCode.INVALID_ARGUMENT, "SLO class"),):
        with pytest.raises(grpc.RpcError) as e:
            stream(ptarget, {"prompt": "hello"}, metadata)
        assert e.value.code() == code and text in e.value.details()
    assert stream(ptarget, {"prompt": "hello"}, [("seldon-slo-class", "interactive")])[-1]["done"]


def test_predict_llm_prompt_equals_jax(servers):
    jtarget, ptarget, _, _ = servers
    # both servers ran no private generate() (meta carries the count)
    msg = SeldonMessage.from_dict({"jsonData": {"prompt": "hello world"}})
    got = grpc_client.call_sync(ptarget, "Predict", msg, timeout_s=TIMEOUT).to_dict()
    assert got == grpc_client.call_sync(jtarget, "Predict", msg, timeout_s=TIMEOUT).to_dict()
    assert got["jsonData"]["texts"][0] is not None


class Doubler:
    """A tiny host model: twice its input."""

    def predict(self, X, names):
        return np.asarray(X) * 2


@pytest.mark.parametrize("payload", [
    {"data": {"tensor": {"shape": [2, 2], "values": [1.0, 2.0, 3.0, 4.0]}}},
    {"data": {"names": ["a", "b"], "ndarray": [[1.5, -2.0]]}},
], ids=["tensor", "ndarray"])
def test_predict_tiny_model_equals_jax(payload):
    jtarget, jsrv = served(jax_server, Doubler())
    ptarget, psrv = served(make_component_server, Doubler())
    try:
        msg = SeldonMessage.from_dict(payload)
        got = grpc_client.call_sync(ptarget, "Predict", msg, timeout_s=TIMEOUT).to_dict()
        want = grpc_client.call_sync(jtarget, "Predict", msg, timeout_s=TIMEOUT).to_dict()
    finally:
        jsrv.stop(None)
        psrv.stop(None)
    assert got == want


def test_predict_torchserver_answers_as_over_rest(tmp_path):
    from seldon_core_tpu_torch.models import get_model
    from seldon_core_tpu_torch.servers.torchserver import TorchServer, export_checkpoint

    m = get_model("resnet18", num_classes=5, fused=True, device="cpu")
    m.init_params(torch.Generator().manual_seed(0))
    export_checkpoint(str(tmp_path), "resnet18", {"params": m.param_tree()},
                      kwargs={"num_classes": 5, "fused": True}, input_shape=[32, 32, 3])
    srv = TorchServer(model_uri=str(tmp_path), device="cpu")
    srv.load()
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).round(3)
    payload = {"data": {"tensor": {"shape": list(x.shape), "values": x.ravel().tolist()}}}
    target, gsrv = served(make_component_server, srv)
    httpd, _ = start(make_component_app(srv, device="cpu"))
    try:
        got = grpc_client.call_sync(target, "Predict", SeldonMessage.from_dict(payload),
                                    timeout_s=TIMEOUT).to_dict()
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/predict",
                                     data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            want = json.loads(r.read())
    finally:
        gsrv.stop(None)
        httpd.shutdown()
        httpd.server_close()
    assert got == want
    assert got["data"]["tensor"]["shape"] == [2, 5]


_X = {"data": {"ndarray": [[1.0, 2.0]]}, "meta": {"puid": "rpc"}}
_FB = {"request": _X, "response": dict(_X, meta={"puid": "rpc", "routing": {"llm": 0}}),
       "reward": 1.0}
# the rpcs the engine slice serves (each compared with the JAX component
# server's reply), and DebugTimeline, compared with the REST app's
# /debug/timeline on the same component
UNPORTED = [
    ("Generic", "TransformInput", SeldonMessage.from_dict(_X), None),
    ("Generic", "TransformOutput", SeldonMessage.from_dict(_X), None),
    ("Router", "Route", SeldonMessage.from_dict(_X), None),
    ("Combiner", "Aggregate", SeldonMessageList(messages=[SeldonMessage.from_dict(_X)] * 2),
     None),
    ("Model", "SendFeedback", Feedback.from_dict(_FB), None),
    ("Generic", "SendFeedback", Feedback.from_dict(_FB), None),
    ("Model", "DebugTimeline", SeldonMessage.from_json_data({"n": 4}), "/debug/timeline?n=4"),
]


@pytest.mark.parametrize("service,method,msg,rest_path", UNPORTED,
                         ids=[f"{s}/{m}" for s, m, *_ in UNPORTED])
def test_unported_rpc_is_unimplemented(servers, service, method, msg, rest_path):
    """The engine slice's rpcs of the JAX method table are served: each
    answers what the JAX component server answers for the same LLM (its
    reply, or its status code and details); DebugTimeline answers the
    REST app's ``/debug/timeline`` payload for the same component."""
    jtarget, ptarget, rest_port, _ = servers

    def call(target):
        try:
            return grpc_client.call_sync(target, method, msg, service=service,
                                         timeout_s=TIMEOUT).to_dict()
        except grpc.RpcError as e:
            return e.code(), e.details()

    got = call(ptarget)
    if rest_path is None:
        assert got == call(jtarget)
        return
    with urllib.request.urlopen(f"http://127.0.0.1:{rest_port}{rest_path}",
                                timeout=TIMEOUT) as r:
        want = json.loads(r.read())
    assert got["jsonData"] == want
    assert set(want) == {"tracing", "tracer_enabled", "timelines", "scaling"}


def test_max_message_size_annotation_is_honoured():
    target, srv = served(make_component_server, Doubler(),
                         annotations={ANNOTATION_GRPC_MAX_MSG_SIZE: "2048"})
    try:
        small = SeldonMessage.from_dict({"data": {"tensor": {"shape": [4], "values": [1.0] * 4}}})
        assert grpc_client.call_sync(target, "Predict", small).to_dict()["data"]["tensor"][
            "values"] == [2.0] * 4
        big = SeldonMessage.from_dict({"data": {"tensor": {"shape": [1000],
                                                           "values": [1.0] * 1000}}})
        with pytest.raises(grpc.RpcError) as e:
            grpc_client.call_sync(target, "Predict", big)
        assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
    finally:
        srv.stop(None)


def test_cli_grpc_without_grpcio_names_the_module(monkeypatch):
    from seldon_core_tpu_torch.transport import cli

    monkeypatch.setitem(sys.modules, "grpc", None)
    monkeypatch.delitem(sys.modules, "seldon_core_tpu_torch.transport.grpc_server",
                        raising=False)
    monkeypatch.setattr(cli, "build_component", lambda *a: pytest.fail("must exit before"))
    with pytest.raises(SystemExit) as e:
        cli.main(["microservice", "Anything", "GRPC", "--device", "cpu"])
    assert "'grpc'" in str(e.value)


def test_cli_grpc_serves(monkeypatch, tmp_path):
    from seldon_core_tpu_torch.transport import cli, grpc_server

    seen = {}
    monkeypatch.setattr(cli, "ANNOTATIONS_FILE", str(tmp_path / "absent"))
    monkeypatch.setattr(cli, "build_component", lambda name, device: Doubler())
    monkeypatch.setattr(grpc_server, "serve_component",
                        lambda component, host, port, annotations: seen.update(
                            c=component, port=port, annotations=annotations))
    cli.main(["microservice", "Anything", "GRPC", "--port", "5123", "--device", "cpu"])
    assert isinstance(seen["c"], Doubler) and seen["port"] == 5123
    assert seen["annotations"] == {}


@pytest.mark.parametrize("annotated", [True, False], ids=["annotated", "absent"])
def test_cli_grpc_reads_the_max_message_size_annotation(monkeypatch, tmp_path, annotated):
    """The CLI reads the pod's annotations file and its gRPC server honours
    ``seldon.io/grpc-max-message-size`` from it: a 2,048-byte limit refuses
    a message the default 4 MiB takes."""
    from seldon_core_tpu_torch.transport import cli, grpc_server

    path = tmp_path / "annotations"
    if annotated:
        path.write_text(f'foo="bar"\n{ANNOTATION_GRPC_MAX_MSG_SIZE}="2048"\n')
    started = {}

    def serve_component(component, host, port, annotations):
        started["annotations"] = annotations
        started["target"], started["server"] = served(make_component_server, component,
                                                      annotations=annotations)

    monkeypatch.setattr(cli, "ANNOTATIONS_FILE", str(path))
    monkeypatch.setattr(cli, "build_component", lambda name, device: Doubler())
    monkeypatch.setattr(grpc_server, "serve_component", serve_component)
    cli.main(["microservice", "Anything", "GRPC", "--device", "cpu"])
    big = SeldonMessage.from_dict({"data": {"tensor": {"shape": [1000], "values": [1.0] * 1000}}})
    try:
        if annotated:
            assert started["annotations"] == {"foo": "bar", ANNOTATION_GRPC_MAX_MSG_SIZE: "2048"}
            with pytest.raises(grpc.RpcError) as e:
                grpc_client.call_sync(started["target"], "Predict", big, timeout_s=TIMEOUT)
            assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        else:
            assert started["annotations"] == {}
            out = grpc_client.call_sync(started["target"], "Predict", big, timeout_s=TIMEOUT)
            assert out.to_dict()["data"]["tensor"]["values"] == [2.0] * 1000
    finally:
        started["server"].stop(None)


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_spec_generate_stream_equals_sse(mode):
    """With speculation on, ``GenerateStream`` events equal SSE's, each
    stream's token events are its done tokens, and those are the JAX
    ``generate()``'s."""
    j = JaxLLMServer(init_random=True, **COMMON)
    j.load()
    params = {"params": jax.tree_util.tree_map(np.asarray, j._params["params"])}
    extra = dict(draft_model="transformer", draft_model_kwargs=KW) if mode == "draft" else {}
    p = LLMServer(device="cpu", spec_mode=mode, spec_k=4, **dict(COMMON, **extra))
    p.load(params=params, draft_params=params if mode == "draft" else None)
    target, srv = served(make_component_server, p)
    httpd, _ = start(make_component_app(p, device="cpu"))
    body = {"prompt": IDS, "max_new_tokens": 9}
    try:
        got = stream(target, body)
        rest = sse(httpd.server_address[1], body)
    finally:
        srv.stop(None)
        httpd.shutdown()
        httpd.server_close()
        p._batcher_service.close()
    assert got == rest
    assert got[-1]["done"] is True
    assert [e["token"] for e in got[:-1]] == got[-1]["tokens"]
    assert got[-1]["tokens"] == j.generate([IDS], max_new_tokens=9)["tokens"][0]
