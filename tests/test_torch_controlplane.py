"""The port's control plane (``seldon_core_tpu_torch/controlplane/``:
quantity, validate, render) held against the JAX package on the CPU:

- ``parse_quantity`` / ``parse_int_or_string`` give the JAX package's value
  or its ValueError on the grammar cases of ``tests/test_controlplane.py``;
- ``default_deployment`` and ``validate_deployment`` give the JAX package's
  defaults and problem strings on every ``deploy/examples`` CR and on the
  CR cases of ``tests/test_controlplane.py`` (valid and invalid), and
  ``require_valid`` raises where it raises;
- ``render_manifests`` equals the JAX package's on the same CRs except for
  render's three documented differences, which come out exactly: the engine
  container's ``command`` naming the port's CLI, ``nvidia.com/gpu`` for
  ``google.com/tpu`` at the same count, and ``nvidia.com/gpu.product`` for
  the TPU-topology node label; nothing else differs. A predictor with an
  explainer renders the JAX package's explainer objects, its default
  container running the port's CLI and explainer class.
"""

import copy
import json
import os

import pytest

from seldon_core_tpu.contracts.graph import SeldonDeploymentSpec as JaxSpec
from seldon_core_tpu.contracts.payload import SeldonError as JaxError
from seldon_core_tpu.controlplane import quantity as jax_quantity
from seldon_core_tpu.controlplane.render import render_manifests as jax_render
from seldon_core_tpu.controlplane.validate import default_deployment as jax_default
from seldon_core_tpu.controlplane.validate import require_valid as jax_require
from seldon_core_tpu.controlplane.validate import validate_deployment as jax_validate
from seldon_core_tpu_torch.contracts.graph import SeldonDeploymentSpec
from seldon_core_tpu_torch.contracts.payload import SeldonError
from seldon_core_tpu_torch.controlplane import quantity
from seldon_core_tpu_torch.controlplane.render import (ENGINE_COMMAND, EXPLAINER_CLASS,
                                                       GPU_PRODUCT_LABEL, GPU_RESOURCE,
                                                       render_manifests)
from seldon_core_tpu_torch.controlplane.validate import (default_deployment, require_valid,
                                                         validate_deployment)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "deploy", "examples")
TPU_RESOURCE = "google.com/tpu"
TPU_TOPOLOGY_LABEL = "cloud.google.com/gke-tpu-topology"

SIMPLE = {"name": "p", "graph": {"name": "m", "type": "MODEL", "implementation": "SIMPLE_MODEL"}}


def sdep(predictors):
    return {"name": "mydep", "predictors": predictors}


def example_crs():
    out = {}
    for fn in sorted(os.listdir(EXAMPLES)):
        with open(os.path.join(EXAMPLES, fn)) as f:
            out[fn] = json.load(f)
    return out


# the CR cases of tests/test_controlplane.py, valid and invalid
CASES = {
    "simple": sdep([SIMPLE]),
    "router without children": sdep([{"name": "p", "graph": {
        "name": "r", "type": "ROUTER", "implementation": "SIMPLE_ROUTER"}}]),
    "duplicate unit names": sdep([{"name": "p", "graph": {
        "name": "x", "type": "TRANSFORMER",
        "children": [{"name": "x", "type": "MODEL", "implementation": "SIMPLE_MODEL"}]}}]),
    "server without modelUri": sdep([{"name": "p", "graph": {
        "name": "m", "type": "MODEL", "implementation": "SKLEARN_SERVER"}}]),
    "traffic sums to 80": sdep([dict(SIMPLE, name="a", traffic=50),
                                dict(SIMPLE, name="b", traffic=30)]),
    "bad dns name": {"name": "Bad_Name", "predictors": [SIMPLE]},
    "hpa min > max": sdep([dict(SIMPLE, hpaSpec={"minReplicas": 5, "maxReplicas": 2})]),
    "combiner without children": sdep([{"name": "p", "graph": {"name": "r", "type": "COMBINER"}}]),
    "traffic split": sdep([dict(SIMPLE, name="a", traffic=90), dict(SIMPLE, name="b", traffic=10)]),
    "shadow": sdep([dict(SIMPLE, name="a", traffic=100), dict(SIMPLE, name="b", shadow=True)]),
    "hpa": sdep([dict(SIMPLE, hpaSpec={"minReplicas": 2, "maxReplicas": 6,
                                       "metrics": [{"type": "Resource"}]})]),
    "component specs": sdep([dict(SIMPLE, componentSpecs=[{"spec": {
        "containers": [{"name": "sidecar", "image": "busybox"}],
        "nodeSelector": {"pool": "gpu"}}}])]),
    "no traffic, two predictors": sdep([dict(SIMPLE, name="a"), {"name": "b", "graph": {
        "name": "m2", "type": "MODEL", "implementation": "SIMPLE_MODEL"}}]),
    "no traffic, three predictors": sdep([dict(SIMPLE, name="a"), {"name": "b", "graph": {
        "name": "m2", "type": "MODEL", "implementation": "SIMPLE_MODEL"}}, {"name": "c", "graph": {
            "name": "m3", "type": "MODEL", "implementation": "SIMPLE_MODEL"}}]),
    "live and shadow, no traffic": sdep([dict(SIMPLE, name="live"), {
        "name": "sh", "shadow": True,
        "graph": {"name": "m2", "type": "MODEL", "implementation": "SIMPLE_MODEL"}}]),
    "bad resource quantities": sdep([{
        "name": "default",
        "graph": {"name": "m", "type": "MODEL", "implementation": "SIMPLE_MODEL"},
        "svcOrchSpec": {"resources": {"requests": {"cpu": "not-a-qty"}}},
        "componentSpecs": [{"spec": {"containers": [
            {"name": "c", "resources": {"limits": {"memory": "4Gi", "cpu": "-1"}}}]}}]}]),
    "svcOrchSpec env and resources": sdep([dict(SIMPLE, svcOrchSpec={
        "env": [{"name": "X", "value": "1"}],
        "resources": {"limits": {"cpu": "2", "memory": "8Gi"}, "requests": {"cpu": "500m"}}},
        labels={"team": "ml"}, annotations={"a": "b"})]),
    "remote endpoint": sdep([{"name": "p", "graph": {
        "name": "m", "type": "MODEL",
        "endpoint": {"service_host": "10.0.0.1", "service_port": 9000, "type": "REST"}}}]),
    "mahalanobis over a JAX_SERVER": sdep([{"name": "p", "graph": {
        "name": "od", "type": "TRANSFORMER", "implementation": "MAHALANOBIS_OD",
        "children": [{"name": "clf", "type": "MODEL", "implementation": "JAX_SERVER",
                      "modelUri": "gs://b/m"}]}}]),
}
ALL = dict(CASES, **{f"example {k}": v for k, v in example_crs().items()})


def to_jax_form(manifests, gpus=1):
    """A port manifest list in the JAX package's form: render's documented
    differences undone, each checked where it must appear (an explainer's
    default container: the port's CLI and explainer class)."""
    out = copy.deepcopy(manifests)
    for m in out:
        if m["kind"] != "Deployment":
            continue
        if m["metadata"]["name"].endswith("-explainer"):
            container = m["spec"]["template"]["spec"]["containers"][0]
            if container.get("name") == "explainer" and "command" in container:
                assert container["command"] == ENGINE_COMMAND
                del container["command"]
                assert container["args"][1] == EXPLAINER_CLASS
                container["args"][1] = "seldon_core_tpu.analytics.explainers.SaliencyExplainer"
            continue
        pod = m["spec"]["template"]["spec"]
        engine = pod["containers"][0]
        assert engine["command"] == ENGINE_COMMAND
        del engine["command"]
        for section in (engine.get("resources") or {}).values():
            if GPU_RESOURCE in section:
                assert gpus > 0 and section[GPU_RESOURCE] == gpus
                section[TPU_RESOURCE] = section.pop(GPU_RESOURCE)
        if GPU_PRODUCT_LABEL in pod.get("nodeSelector", {}):
            pod["nodeSelector"][TPU_TOPOLOGY_LABEL] = pod["nodeSelector"].pop(GPU_PRODUCT_LABEL)
    return out


def outcome(fn):
    try:
        return ("ok", fn())
    except (SeldonError, JaxError) as e:
        return ("error", type(e).__name__, str(e), e.status_code)


# ----------------------------------------------------------------- quantity
@pytest.mark.parametrize("value", ["500m", "1Gi", "1.5G", "2", 3, 2.5, "1e3", "128Ki", "",
                                   "abc", "1GiB", "--1", "1 Gi", "-4", "+7M", ".5", "3Ei"])
def test_parse_quantity_equals_jax(value):
    def run(mod):
        try:
            return mod.parse_quantity(value)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(quantity) == run(jax_quantity)


@pytest.mark.parametrize("value", [5, "5", "25%", "http", "-3", True])
def test_parse_int_or_string_equals_jax(value):
    def run(mod):
        try:
            return mod.parse_int_or_string(value)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(quantity) == run(jax_quantity)


# ----------------------------------------------------------------- validate
@pytest.mark.parametrize("case", sorted(ALL))
def test_validate_equals_jax(case):
    cr = ALL[case]
    j, p = jax_default(JaxSpec.from_dict(cr)), default_deployment(SeldonDeploymentSpec.from_dict(cr))
    assert p.to_dict() == j.to_dict()
    # undefaulted too: defaulting must not hide a difference
    assert validate_deployment(SeldonDeploymentSpec.from_dict(cr)) == \
        jax_validate(JaxSpec.from_dict(cr))
    assert validate_deployment(p) == jax_validate(j)
    got = outcome(lambda: require_valid(SeldonDeploymentSpec.from_dict(cr)).to_dict())
    want = outcome(lambda: jax_require(JaxSpec.from_dict(cr)).to_dict())
    assert got[:1] == want[:1] and got[2:] == want[2:]


def test_mahalanobis_is_self_contained():
    cr = CASES["mahalanobis over a JAX_SERVER"]
    assert validate_deployment(SeldonDeploymentSpec.from_dict(cr)) == []


# ------------------------------------------------------------------- render
@pytest.mark.parametrize("case", sorted(ALL))
@pytest.mark.parametrize("gpus,product", [(1, None), (4, "NVIDIA-H100-80GB-HBM3"), (0, None)])
def test_render_equals_jax_up_to_the_three_differences(case, gpus, product):
    cr = ALL[case]
    kw = dict(namespace="ns1", engine_image="r/engine:v1")
    got = outcome(lambda: render_manifests(SeldonDeploymentSpec.from_dict(cr), gpus=gpus,
                                           gpu_product=product, **kw))
    want = outcome(lambda: jax_render(JaxSpec.from_dict(cr), tpu_chips=gpus,
                                      tpu_topology=product, **kw))
    assert got[0] == want[0]
    if got[0] == "error":
        assert got[2:] == want[2:]
        return
    assert to_jax_form(got[1], gpus) == want[1]
    # the differences are really there
    deps = [m for m in got[1] if m["kind"] == "Deployment"]
    for d in deps:
        pod = d["spec"]["template"]["spec"]
        engine = pod["containers"][0]
        assert engine["command"] == ["python", "-m", "seldon_core_tpu_torch.transport.cli"]
        assert TPU_RESOURCE not in json.dumps(d) and TPU_TOPOLOGY_LABEL not in json.dumps(d)
        if gpus:
            assert engine["resources"]["limits"][GPU_RESOURCE] == gpus
            assert engine["resources"]["requests"][GPU_RESOURCE] == gpus
        assert pod.get("nodeSelector", {}).get(GPU_PRODUCT_LABEL) == product


def test_render_defaults_equal_jax():
    cr = CASES["simple"]
    got = render_manifests(SeldonDeploymentSpec.from_dict(cr))
    assert to_jax_form(got) == jax_render(JaxSpec.from_dict(cr))


def test_render_without_validation_equals_jax():
    cr = CASES["router without children"]
    got = render_manifests(SeldonDeploymentSpec.from_dict(cr), validate=False)
    assert to_jax_form(got) == jax_render(JaxSpec.from_dict(cr), validate=False)


@pytest.mark.parametrize("explainer", [
    {"type": "saliency", "modelUri": "gs://b/m"},
    {"type": "saliency", "serviceAccountName": "sa", "envSecretRefName": "creds"},
    {"type": "anchors", "containerSpec": {"name": "x", "image": "my/explainer:1"},
     "envSecretRefName": "creds"}])
def test_explainer_raises_naming_the_analytics_slice(explainer):
    """The analytics slice is here: a predictor's explainer renders the JAX
    package's Deployment and Service, the port's CLI and class in its
    default container, a ``containerSpec`` untouched; an unsupported type
    without one raises the JAX package's error word for word."""
    graph = dict(SIMPLE["graph"], modelUri="gs://b/graph")
    cr = sdep([dict(SIMPLE, graph=graph, explainer=explainer)])
    got = render_manifests(SeldonDeploymentSpec.from_dict(cr), namespace="ns", engine_image="e:1")
    assert to_jax_form(got) == jax_render(JaxSpec.from_dict(cr), namespace="ns",
                                          engine_image="e:1")
    assert [m["kind"] for m in got if m["metadata"]["name"].endswith("-explainer")] == [
        "Deployment", "Service"]
    bad = sdep([dict(SIMPLE, explainer={"type": "anchors"})])
    assert (outcome(lambda: render_manifests(SeldonDeploymentSpec.from_dict(bad)))
            == outcome(lambda: jax_render(JaxSpec.from_dict(bad))))
    assert outcome(lambda: render_manifests(SeldonDeploymentSpec.from_dict(bad)))[0] == "error"
