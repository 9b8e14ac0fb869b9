"""SeldonDeployment CR -> Kubernetes manifests, the port's renderer.

Port of ``seldon_core_tpu/controlplane/render.py``, the capability of the
reference operator's reconcile step (SURVEY.md §3.4: per-predictor
Deployments with the engine container injected and ``ENGINE_PREDICTOR``
carrying the base64 predictor spec, Services, ingress annotations, HPA), as
a pure function for the operator loop (``controlplane/operator.py``) and the
CLI's ``render``.

Its manifests equal the JAX package's but for the differences below, each
pinned by a test that diffs the two outputs (``tests/test_torch_controlplane.py``):

- the engine container runs the port's CLI: ``command: ["python", "-m",
  "seldon_core_tpu_torch.transport.cli"]`` before the same ``args`` (the
  JAX package's container has no ``command``: its image's entrypoint is
  the JAX CLI);
- the engine container requests ``nvidia.com/gpu`` where the JAX package
  requests ``google.com/tpu``, the same count under the name ``gpus``;
- the JAX package's ``cloud.google.com/gke-tpu-topology`` nodeSelector is
  an optional ``gpu_product`` under the ``nvidia.com/gpu.product`` node
  label (what the NVIDIA GPU feature discovery labels a node with).

A predictor with an ``explainer`` gets the JAX package's explainer
Deployment and Service; its default container runs the port's CLI as the
engine's does (the same ``command``) and serves the port's
``seldon_core_tpu_torch.analytics.explainers.SaliencyExplainer`` where the
JAX package names its own class. A ``containerSpec`` replaces that
container wholesale, as in the JAX package.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Dict, List, Optional

from seldon_core_tpu_torch.contracts.graph import PredictorSpec, SeldonDeploymentSpec
from seldon_core_tpu_torch.contracts.payload import SeldonError
from seldon_core_tpu_torch.controlplane.validate import require_valid

DEFAULT_ENGINE_IMAGE = "seldon-core-tpu/engine:latest"
ENGINE_COMMAND = ["python", "-m", "seldon_core_tpu_torch.transport.cli"]
GPU_RESOURCE = "nvidia.com/gpu"
GPU_PRODUCT_LABEL = "nvidia.com/gpu.product"
ENGINE_HTTP_PORT = 8000
ENGINE_GRPC_PORT = 5001
METRICS_PATH = "/metrics"


def _dep_labels(sdep: SeldonDeploymentSpec, p: PredictorSpec) -> Dict[str, str]:
    return {
        "app": f"{sdep.name}-{p.name}",
        "seldon-deployment-id": sdep.name,
        "seldon-predictor": p.name,
        **p.labels,
    }


def _engine_container(
    sdep: SeldonDeploymentSpec,
    p: PredictorSpec,
    engine_image: str,
    gpus: int,
) -> Dict[str, Any]:
    env = [
        {"name": "DEPLOYMENT_NAME", "value": sdep.name},
        {"name": "PREDICTOR_ID", "value": p.name},
        {
            "name": "ENGINE_PREDICTOR",
            "value": base64.b64encode(json.dumps(p.to_dict()).encode()).decode(),
        },
        {"name": "ENGINE_SERVER_PORT", "value": str(ENGINE_HTTP_PORT)},
        {"name": "ENGINE_SERVER_GRPC_PORT", "value": str(ENGINE_GRPC_PORT)},
    ]
    for item in p.svc_orch_spec.get("env", []) or []:
        env.append(item)
    resources: Dict[str, Any] = p.svc_orch_spec.get("resources") or {}
    if gpus > 0:
        resources = {
            "limits": {**resources.get("limits", {}), GPU_RESOURCE: gpus},
            "requests": {**resources.get("requests", {}), GPU_RESOURCE: gpus},
        }
    container = {
        "name": "seldon-engine-tpu",
        "image": engine_image,
        "command": list(ENGINE_COMMAND),
        "args": ["engine", "--port", str(ENGINE_HTTP_PORT)],
        "env": env,
        "ports": [
            {"name": "http", "containerPort": ENGINE_HTTP_PORT},
            {"name": "grpc", "containerPort": ENGINE_GRPC_PORT},
        ],
        "readinessProbe": {
            "httpGet": {"path": "/ready", "port": ENGINE_HTTP_PORT},
            "initialDelaySeconds": 10,
            "periodSeconds": 5,
        },
        "livenessProbe": {
            "httpGet": {"path": "/live", "port": ENGINE_HTTP_PORT},
            "initialDelaySeconds": 20,
            "periodSeconds": 10,
        },
        "lifecycle": {
            # drain before shutdown: the reference's /pause rollout contract
            "preStop": {
                "httpGet": {"path": "/pause", "port": ENGINE_HTTP_PORT},
            }
        },
    }
    if resources:
        container["resources"] = resources
    return container


def _deployment(
    sdep: SeldonDeploymentSpec,
    p: PredictorSpec,
    namespace: str,
    engine_image: str,
    gpus: int,
    gpu_product: Optional[str],
) -> Dict[str, Any]:
    labels = _dep_labels(sdep, p)
    containers = [_engine_container(sdep, p, engine_image, gpus)]
    node_selector: Dict[str, str] = {}
    if gpu_product:
        node_selector[GPU_PRODUCT_LABEL] = gpu_product
    for cs in p.component_specs:
        spec = cs.get("spec", cs)
        containers.extend(spec.get("containers", []) or [])
        node_selector.update(spec.get("nodeSelector", {}) or {})
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": f"{sdep.name}-{p.name}",
            "namespace": namespace,
            "labels": labels,
            "annotations": {**sdep.annotations, **p.annotations},
        },
        "spec": {
            "replicas": p.replicas,
            "selector": {"matchLabels": {"app": labels["app"]}},
            "template": {
                "metadata": {
                    "labels": labels,
                    "annotations": {
                        "prometheus.io/scrape": "true",
                        "prometheus.io/path": METRICS_PATH,
                        "prometheus.io/port": str(ENGINE_HTTP_PORT),
                    },
                },
                "spec": {
                    "containers": containers,
                    **({"nodeSelector": node_selector} if node_selector else {}),
                    "terminationGracePeriodSeconds": 30,
                },
            },
        },
    }


def _service(sdep: SeldonDeploymentSpec, p: PredictorSpec, namespace: str) -> Dict[str, Any]:
    labels = _dep_labels(sdep, p)
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": f"{sdep.name}-{p.name}",
            "namespace": namespace,
            "labels": labels,
        },
        "spec": {
            "selector": {"app": labels["app"]},
            "ports": [
                {"name": "http", "port": ENGINE_HTTP_PORT, "targetPort": ENGINE_HTTP_PORT},
                {"name": "grpc", "port": ENGINE_GRPC_PORT, "targetPort": ENGINE_GRPC_PORT},
            ],
        },
    }


def _hpa(sdep: SeldonDeploymentSpec, p: PredictorSpec, namespace: str) -> Dict[str, Any]:
    return {
        "apiVersion": "autoscaling/v2",
        "kind": "HorizontalPodAutoscaler",
        "metadata": {"name": f"{sdep.name}-{p.name}", "namespace": namespace},
        "spec": {
            "scaleTargetRef": {
                "apiVersion": "apps/v1",
                "kind": "Deployment",
                "name": f"{sdep.name}-{p.name}",
            },
            "minReplicas": p.hpa_spec.get("minReplicas", 1),
            "maxReplicas": p.hpa_spec["maxReplicas"],
            **({"metrics": p.hpa_spec["metrics"]} if p.hpa_spec.get("metrics") else {}),
        },
    }


def _virtual_service(sdep: SeldonDeploymentSpec, namespace: str) -> Dict[str, Any]:
    routes = [
        {
            "destination": {
                "host": f"{sdep.name}-{p.name}.{namespace}.svc.cluster.local",
                "port": {"number": ENGINE_HTTP_PORT},
            },
            "weight": p.traffic,
        }
        for p in sdep.predictors
        if not p.shadow
    ]
    vs: Dict[str, Any] = {
        "apiVersion": "networking.istio.io/v1beta1",
        "kind": "VirtualService",
        "metadata": {"name": sdep.name, "namespace": namespace},
        "spec": {
            "hosts": [sdep.name],
            "http": [
                {
                    "match": [{"uri": {"prefix": f"/seldon/{namespace}/{sdep.name}/"}}],
                    "rewrite": {"uri": "/"},
                    "route": routes,
                }
            ],
        },
    }
    shadows = [p for p in sdep.predictors if p.shadow]
    if shadows:
        vs["spec"]["http"][0]["mirror"] = {
            "host": f"{sdep.name}-{shadows[0].name}.{namespace}.svc.cluster.local",
            "port": {"number": ENGINE_HTTP_PORT},
        }
    return vs


EXPLAINER_CLASS = "seldon_core_tpu_torch.analytics.explainers.SaliencyExplainer"


def _explainer_objects(
    sdep: SeldonDeploymentSpec, p: PredictorSpec, namespace: str, engine_image: str
) -> List[Dict[str, Any]]:
    """Explainer Deployment + Service for a predictor carrying the CRD
    ``explainer`` field (`proto/seldon_deployment.proto:45-51,63`). Default
    container serves the port's ``SaliencyExplainer`` over the predictor's
    modelUri through the port's CLI; ``containerSpec`` overrides it
    wholesale."""
    exp = p.explainer
    exp_type = exp.get("type", "saliency") or "saliency"
    if not exp.get("containerSpec") and exp_type not in ("saliency",):
        raise SeldonError(
            f"unsupported explainer type {exp_type!r}: built-in support is "
            "'saliency'; other explainers need an explicit containerSpec",
            reason="BAD_GRAPH",
        )
    name = f"{sdep.name}-{p.name}-explainer"
    labels = {**_dep_labels(sdep, p), "seldon-explainer": p.name}
    # copy: the spec's nested dict must not accumulate mutations (envFrom)
    # across renders of the same held spec object
    container = dict(exp["containerSpec"]) if exp.get("containerSpec") else None
    if not container:
        model_uri = exp.get("modelUri") or p.graph.model_uri or ""
        container = {
            "name": "explainer",
            "image": engine_image,
            "command": list(ENGINE_COMMAND),
            "args": ["microservice", EXPLAINER_CLASS, "REST"],
            "env": [
                {"name": "PREDICTIVE_UNIT_SERVICE_PORT", "value": str(ENGINE_HTTP_PORT)},
                {"name": "PREDICTIVE_UNIT_PARAMETERS", "value": json.dumps([
                    {"name": "model_uri", "value": model_uri, "type": "STRING"},
                ])},
            ],
            "ports": [{"name": "http", "containerPort": ENGINE_HTTP_PORT}],
        }
    pod_spec: Dict[str, Any] = {"containers": [container]}
    if exp.get("serviceAccountName"):
        pod_spec["serviceAccountName"] = exp["serviceAccountName"]
    if exp.get("envSecretRefName"):
        container["envFrom"] = list(container.get("envFrom", [])) + [
            {"secretRef": {"name": exp["envSecretRefName"]}}
        ]
    deployment = {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": name, "namespace": namespace, "labels": labels},
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": {"seldon-explainer-app": name}},
            "template": {
                "metadata": {"labels": {**labels, "seldon-explainer-app": name}},
                "spec": pod_spec,
            },
        },
    }
    service = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": name, "namespace": namespace, "labels": labels},
        "spec": {
            "selector": {"seldon-explainer-app": name},
            "ports": [{"name": "http", "port": ENGINE_HTTP_PORT,
                       "targetPort": ENGINE_HTTP_PORT}],
        },
    }
    return [deployment, service]


def render_manifests(
    sdep: SeldonDeploymentSpec,
    namespace: str = "default",
    engine_image: str = DEFAULT_ENGINE_IMAGE,
    gpus: int = 1,
    gpu_product: Optional[str] = None,
    validate: bool = True,
) -> List[Dict[str, Any]]:
    """Render the full manifest set for one SeldonDeployment CR: per
    predictor a Deployment, a Service and (with ``hpaSpec.maxReplicas``) an
    HPA, then a VirtualService when traffic splits or mirrors."""
    if validate:
        sdep = require_valid(sdep)
    out: List[Dict[str, Any]] = []
    for p in sdep.predictors:
        out.append(_deployment(sdep, p, namespace, engine_image, gpus, gpu_product))
        out.append(_service(sdep, p, namespace))
        if p.hpa_spec.get("maxReplicas"):
            out.append(_hpa(sdep, p, namespace))
        if p.explainer:
            out.extend(_explainer_objects(sdep, p, namespace, engine_image))
    if len([p for p in sdep.predictors if not p.shadow]) > 1 or any(
        p.shadow for p in sdep.predictors
    ):
        out.append(_virtual_service(sdep, namespace))
    return out
