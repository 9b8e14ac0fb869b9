"""The port's CLI (seldon_core_tpu_torch/transport/cli.py) held against the
JAX package's: a user component built from a model file in the working
directory with its typed ``PREDICTIVE_UNIT_PARAMETERS``.

- a plain component whose constructor takes no ``device`` (``__init__(self,
  scale=1.0)``) is built by the port as ``klass(**parameters)``, as the
  reference builds it, and its REST ``/predict`` answer on the CPU equals
  the reference's dispatch of the same request;
- a class whose constructor names ``device`` or takes ``**kwargs`` still
  receives the CLI's ``--device``."""

import json
import sys
import textwrap
import urllib.request

import numpy as np
import pytest

from seldon_core_tpu.components import dispatch as jax_dispatch
from seldon_core_tpu.contracts.payload import SeldonMessage as JaxMessage
from seldon_core_tpu.transport import cli as jax_cli
from seldon_core_tpu_torch.transport import cli
from seldon_core_tpu_torch.transport.rest import make_component_app, start

MODEL = """
import numpy as np
from {pkg}.components.component import SeldonComponent


class {name}(SeldonComponent):
    def __init__(self, scale=1.0):
        self.scale = scale

    def predict(self, X, names, meta=None):
        return np.asarray(X) * self.scale

    def tags(self):
        return {{"scale": self.scale}}
"""

DEVICE_MODELS = """
from seldon_core_tpu_torch.components.component import SeldonComponent


class TakesDevice(SeldonComponent):
    def __init__(self, scale=1.0, device=None):
        self.scale, self.device_arg = scale, device


class TakesKwargs(SeldonComponent):
    def __init__(self, scale=1.0, **kwargs):
        self.scale, self.kwargs = scale, kwargs
"""

PARAMS = json.dumps([{"name": "scale", "value": "3.0", "type": "FLOAT"}])
REQUEST = {"meta": {"puid": "cli-1"}, "data": {"names": ["a", "b"],
                                                "ndarray": [[1.0, 2.5], [-4.0, 0.5]]}}


@pytest.fixture
def model_dir(tmp_path, monkeypatch):
    (tmp_path / "PortModel.py").write_text(
        MODEL.format(pkg="seldon_core_tpu_torch", name="PortModel"))
    (tmp_path / "RefModel.py").write_text(MODEL.format(pkg="seldon_core_tpu", name="RefModel"))
    (tmp_path / "DeviceModels.py").write_text(textwrap.dedent(DEVICE_MODELS))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "path", list(sys.path))   # import_interface prepends the cwd
    for name in ("PortModel", "RefModel", "DeviceModels"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setenv("PREDICTIVE_UNIT_PARAMETERS", PARAMS)
    return tmp_path


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_component_without_device_serves_as_the_reference(model_dir):
    assert not cli.takes_device(cli.import_interface("PortModel"))
    component = cli.build_component("PortModel", "cpu")
    assert component.scale == 3.0
    ref, _ = jax_cli.build_component("RefModel")   # (component, persistence threads)
    want = jax_dispatch.predict(ref, JaxMessage.from_dict(REQUEST)).to_dict()
    httpd, _ = start(make_component_app(component, device="cpu"))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        code, got = _post(url + "/predict", REQUEST)
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert code == 200
    assert got == want
    np.testing.assert_allclose(got["data"]["ndarray"], [[3.0, 7.5], [-12.0, 1.5]])
    assert got["meta"]["tags"] == {"scale": 3.0} and got["meta"]["puid"] == "cli-1"


@pytest.mark.parametrize("name", ["TakesDevice", "TakesKwargs"])
def test_component_taking_device_still_receives_it(model_dir, name):
    component = cli.build_component(f"DeviceModels.{name}", "cpu")
    assert component.scale == 3.0
    got = component.device_arg if name == "TakesDevice" else component.kwargs["device"]
    assert got == "cpu"


def test_constructor_rejecting_the_parameters_exits(model_dir, monkeypatch):
    monkeypatch.setenv("PREDICTIVE_UNIT_PARAMETERS",
                       json.dumps([{"name": "bogus", "value": "1", "type": "INT"}]))
    with pytest.raises(SystemExit, match="bogus"):
        cli.build_component("PortModel", "cpu")


def test_engine_spec_sources_as_jax(tmp_path, monkeypatch):
    """``engine``'s spec: ``--spec`` file, else ENGINE_PREDICTOR (base64),
    else the reference's default SIMPLE_MODEL graph — the JAX CLI's
    ``_load_spec`` on each source."""
    import base64

    monkeypatch.chdir(tmp_path)  # no ./deploymentdef.json here
    monkeypatch.delenv("ENGINE_PREDICTOR", raising=False)
    assert cli.load_spec(None).to_dict() == jax_cli._load_spec(None).to_dict()
    graph = {"name": "g", "graph": {"name": "ab", "type": "ROUTER",
                                    "implementation": "RANDOM_ABTEST",
                                    "children": [{"name": "a", "type": "MODEL"}]}}
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(graph))
    assert cli.load_spec(str(path)).to_dict() == jax_cli._load_spec(str(path)).to_dict()
    monkeypatch.setenv("ENGINE_PREDICTOR", base64.b64encode(json.dumps(graph).encode()).decode())
    assert cli.load_spec(None).to_dict() == jax_cli._load_spec(None).to_dict()


@pytest.mark.parametrize("api,match", [("IPC", "native-edge slice"), ("SOAP", "Unknown API")])
def test_engine_refuses_other_apis(api, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(["engine", "--api", api, "--device", "cpu"])
