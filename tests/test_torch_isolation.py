"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, and it never falls back to the CPU on its own.

- a subprocess with ``jax``, ``flax``, ``msgpack`` and ``seldon_core_tpu``
  blocked from import imports every module of ``seldon_core_tpu_torch``
  (the gRPC server, its proto converters and copied stubs, the OpenAPI
  spec, the metrics registry, the radix prefix cache, the adapter pool,
  the scheduler, the disaggregation module, the frame codec and the
  parallel package among them), serves one CPU ``generate()``, one over a
  co-located {"seq": 2, "model": 2} mesh, takes one training step of a
  ring-attention model over that mesh, and the same prompt through a
  disaggregated batcher over the network handoff, writes an LLM
  checkpoint and serves it through ``LLMServer(model_uri=...)`` with an
  adapter pool, writes, loads and serves a ResNet checkpoint through
  ``TorchServer``, a ViT checkpoint in int8 and its saliency explainer,
  and boots the ``engine`` CLI on its default SIMPLE_MODEL
  graph and serves a prediction through it (the graph engine, its
  builtins, bandit routers, resilience and no-op tracer among the modules
  it requires);
- an AST walk over the package and ``chip_smoke.py`` finds no import of
  ``jax``, ``flax``, ``msgpack`` or ``seldon_core_tpu`` / ``seldon_core_tpu.*``;
- ``LLMServer()``, ``GraphEngine()``, ``make_engine_app()``,
  ``init_train_state()``, the predict models and ``SaliencyExplainer()``
  with no ``device`` raise when no CUDA device is
  present.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "seldon_core_tpu_torch"

BLOCKED_RUN = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "seldon_core_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import seldon_core_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(seldon_core_tpu_torch.__path__,
                                              "seldon_core_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
need = {"seldon_core_tpu_torch.transport." + m for m in (
    "grpc_server", "proto_convert", "proto.prediction_pb2", "openapi", "streaming")}
need |= {"seldon_core_tpu_torch.metrics.registry", "seldon_core_tpu_torch.runtime.radix",
         "seldon_core_tpu_torch.runtime.adapters", "seldon_core_tpu_torch.runtime.scheduler"}
need |= {"seldon_core_tpu_torch." + m for m in (
    "runtime.engine", "runtime.resilience", "components.builtin", "components.metrics",
    "analytics.routers", "tracing", "contracts.graph", "runtime.disagg", "codec.framing",
    "tracing.export", "runtime.flight", "observability.timeline")}
need |= {"seldon_core_tpu_torch." + m for m in (
    "controlplane", "controlplane.quantity", "controlplane.validate", "controlplane.render",
    "controlplane.charts", "controlplane.operator", "controlplane.autoscaler",
    "analytics.outliers", "analytics.canary")}
need |= {"seldon_core_tpu_torch." + m for m in (
    "parallel", "parallel.topology", "parallel.mesh", "parallel.multihost",
    "parallel.sharding", "parallel.collectives", "models.sharded", "parallel.train",
    "parallel.pipeline", "ops.ring_attention")}
need |= {"seldon_core_tpu_torch." + m for m in (
    "models.mlp", "models.vit", "models.layers", "analytics.explainers")}
need |= {"seldon_core_tpu_torch." + m for m in (
    "analytics.threefry", "utils", "client", "client.client", "client.contract",
    "client.testers", "client.loadgen", "observability.request_logger",
    "observability.dashboards", "packaging.wrap", "integrations.sagemaker")}
assert need <= set(mods), need - set(mods)
from seldon_core_tpu_torch.servers.llmserver import LLMServer
s = LLMServer(model="llama-tiny", init_random=True, max_new_tokens=4, eos_id=-1,
              len_buckets=(16,), batch_buckets=(1,), device="cpu")
out = s.generate(["hi"])
assert len(out["tokens"][0]) == 4, out
from seldon_core_tpu_torch.parallel.topology import Topology
tp = LLMServer(model="llama-tiny", init_random=True, max_new_tokens=4, eos_id=-1,
               len_buckets=(16,), batch_buckets=(1,), device="cpu", tensor_parallel=2,
               sequence_parallel=2, topology=Topology(devices=["cpu"] * 4))
assert len(tp.generate(["hi"])["tokens"][0]) == 4
import torch
from seldon_core_tpu_torch.models import get_model
from seldon_core_tpu_torch.parallel import train
m = get_model("llama-tiny", device="cpu", attention_impl="ring", fused_norm=True)
st = train.init_train_state(m, train.adamw(1e-3), Topology(devices=["cpu"] * 4).mesh(
    {"seq": 2, "model": 2}), seed=0, device="cpu")
st, met = train.make_train_step(train.adamw(1e-3))(st, torch.randint(0, 255, (2, 8)))
assert st.step == 1 and bool(torch.isfinite(met["loss"])), met
from seldon_core_tpu_torch.runtime.batcher import ContinuousBatcher
d = LLMServer(model="llama-tiny", init_random=True, max_new_tokens=4, eos_id=-1,
              len_buckets=(16,), batch_buckets=(1,), device="cpu",
              disaggregation="remote_prefill", handoff_transport="network")
d.load()
b = ContinuousBatcher(d, device="cpu", max_slots=2)
assert b.submit("hi", 4).result(60) == out["tokens"][0]
b.close()
import tempfile, numpy as np, torch
from seldon_core_tpu_torch.models import get_model
from seldon_core_tpu_torch.servers.torchserver import TorchServer, export_checkpoint
with tempfile.TemporaryDirectory() as d:
    export_checkpoint(d, "llama-tiny", {"params": s._module.param_tree()})
    t = LLMServer(model_uri=d, max_new_tokens=4, eos_id=-1, len_buckets=(16,),
                  batch_buckets=(1,), device="cpu", lora_rank=2, lora_max_adapters=2)
    t.load()
assert t.generate(["hi"]) == out and t.adapter_registry.stats()["adapter_capacity"] == 1
m = get_model("resnet18", num_classes=5, fused=True, device="cpu")
m.init_params(torch.Generator().manual_seed(0))
with tempfile.TemporaryDirectory() as d:
    export_checkpoint(d, "resnet18", {"params": m.param_tree()},
                      kwargs={"num_classes": 5, "fused": True}, input_shape=[32, 32, 3])
    srv = TorchServer(model_uri=d, device="cpu")
    srv.load()
x = np.random.default_rng(0).standard_normal((3, 32, 32, 3)).astype(np.float32)
assert srv.predict(x, []).shape == (3, 5)
from seldon_core_tpu_torch.analytics.explainers import SaliencyExplainer
v = get_model("vit-tiny", num_classes=3, input_shape=[8, 8, 3], device="cpu")
v.init_params(torch.Generator().manual_seed(0))
with tempfile.TemporaryDirectory() as d:
    export_checkpoint(d, "vit-tiny", {"params": v.param_tree()}, kwargs={"num_classes": 3},
                      input_shape=[8, 8, 3])
    vs = TorchServer(model_uri=d, quantize="int8", device="cpu")
    vs.load()
    ex = SaliencyExplainer(model_uri=d, device="cpu")
    ex.load()
xv = np.random.default_rng(1).standard_normal((2, 8, 8, 3)).astype(np.float32)
assert vs.predict(xv, []).shape == (2, 3) and ex.predict(xv, []).shape == (2, 8, 8, 3)
# the engine CLI on its default SIMPLE_MODEL graph, over REST
import json, socket, threading, time, urllib.request
from seldon_core_tpu_torch.transport import cli
sock = socket.socket()
sock.bind(("127.0.0.1", 0))
port = sock.getsockname()[1]
sock.close()
threading.Thread(target=cli.main, daemon=True, args=(
    ["engine", "--device", "cpu", "--host", "127.0.0.1", "--port", str(port)],)).start()
for _ in range(400):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/ready", timeout=1) as r:
            if r.status == 200:
                break
    except OSError:
        time.sleep(0.05)
req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v0.1/predictions",
                             data=json.dumps({"data": {"ndarray": [[1.0, 2.0]]}}).encode(),
                             headers={"Content-Type": "application/json"})
with urllib.request.urlopen(req, timeout=30) as r:
    got = json.loads(r.read())
assert got["meta"]["requestPath"] == {"simple": "SimpleModel"}, got
assert got["data"]["names"] == ["class0", "class1", "class2"], got
print("OK", len(mods))
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n_modules = int(proc.stdout.split()[-1])
    assert n_modules >= 30, proc.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "flax", "msgpack", "seldon_core_tpu")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_imports(path):
    bad = sorted({n for n in _imports(path) if _forbidden(n)})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_default_device_raises_without_cuda(monkeypatch):
    from seldon_core_tpu_torch.device import resolve_device
    from seldon_core_tpu_torch.models import get_model
    from seldon_core_tpu_torch.servers.llmserver import LLMServer
    from seldon_core_tpu_torch.servers.torchserver import TorchServer
    from seldon_core_tpu_torch.contracts.graph import PredictorSpec
    from seldon_core_tpu_torch.runtime.engine import GraphEngine
    from seldon_core_tpu_torch.transport.rest import make_engine_app

    spec = PredictorSpec.from_dict({"name": "p", "graph": {
        "name": "m", "type": "MODEL", "implementation": "SIMPLE_MODEL"}})
    cpu_engine = GraphEngine(spec, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        GraphEngine(spec)
    with pytest.raises(RuntimeError, match="cuda"):
        make_engine_app(cpu_engine)
    with pytest.raises(RuntimeError, match="cuda"):
        LLMServer(model="llama-tiny", init_random=True)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchServer(model_uri="/nowhere")
    with pytest.raises(RuntimeError, match="cuda"):
        get_model("resnet50", fused=True)
    for name in ("vit-b16", "mlp"):
        with pytest.raises(RuntimeError, match="cuda"):
            get_model(name)
    from seldon_core_tpu_torch.analytics.explainers import SaliencyExplainer
    with pytest.raises(RuntimeError, match="cuda"):
        SaliencyExplainer(model_uri="/nowhere")
    from seldon_core_tpu_torch.analytics.outliers import Seq2SeqOutlierDetector, VAEOutlierDetector
    for detector in (VAEOutlierDetector, Seq2SeqOutlierDetector):
        with pytest.raises(RuntimeError, match="cuda"):
            detector()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    from seldon_core_tpu_torch.parallel.train import adamw, init_train_state
    with pytest.raises(RuntimeError, match="cuda"):
        init_train_state(get_model("llama-tiny", device="cpu"), adamw(1e-3))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
