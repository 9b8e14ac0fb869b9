"""Inference-graph spec of the port, copied from
``seldon_core_tpu/contracts/graph.py``: the same JSON shape as the
reference CRD (`proto/seldon_deployment.proto:11-161`). A deployment has
predictors; each predictor has a recursive ``graph`` of ``PredictiveUnit``
nodes with a type (MODEL/ROUTER/COMBINER/TRANSFORMER/OUTPUT_TRANSFORMER), an
optional built-in implementation, typed parameters, an endpoint (a remote
node) and a modelUri (a prepackaged server).

A unit with no ``endpoint`` is an in-process component; the whole graph of
in-process units runs in one engine process
(``seldon_core_tpu_torch.runtime.engine``).
"""

from __future__ import annotations

import base64
import json
import os
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

from seldon_core_tpu_torch.contracts.parameters import Parameter
from seldon_core_tpu_torch.contracts.payload import SeldonError


class UnitType(str, Enum):
    """`proto/seldon_deployment.proto` PredictiveUnitType."""

    UNKNOWN_TYPE = "UNKNOWN_TYPE"
    ROUTER = "ROUTER"
    COMBINER = "COMBINER"
    MODEL = "MODEL"
    TRANSFORMER = "TRANSFORMER"
    OUTPUT_TRANSFORMER = "OUTPUT_TRANSFORMER"


class UnitImplementation(str, Enum):
    """Built-in implementations (`proto/seldon_deployment.proto:102-113`).

    The *_SERVER values select prepackaged servers; JAX_SERVER maps to the
    port's ``TorchServer``. The analytics units are in-process
    implementations selectable from the spec.
    """

    UNKNOWN_IMPLEMENTATION = "UNKNOWN_IMPLEMENTATION"
    SIMPLE_MODEL = "SIMPLE_MODEL"
    SIMPLE_ROUTER = "SIMPLE_ROUTER"
    RANDOM_ABTEST = "RANDOM_ABTEST"
    AVERAGE_COMBINER = "AVERAGE_COMBINER"
    SKLEARN_SERVER = "SKLEARN_SERVER"
    XGBOOST_SERVER = "XGBOOST_SERVER"
    TENSORFLOW_SERVER = "TENSORFLOW_SERVER"
    MLFLOW_SERVER = "MLFLOW_SERVER"
    JAX_SERVER = "JAX_SERVER"
    EPSILON_GREEDY = "EPSILON_GREEDY"
    THOMPSON_SAMPLING = "THOMPSON_SAMPLING"
    MAHALANOBIS_OD = "MAHALANOBIS_OD"
    ISOLATION_FOREST_OD = "ISOLATION_FOREST_OD"
    VAE_OD = "VAE_OD"
    SEQ2SEQ_OD = "SEQ2SEQ_OD"


class UnitMethod(str, Enum):
    TRANSFORM_INPUT = "TRANSFORM_INPUT"
    TRANSFORM_OUTPUT = "TRANSFORM_OUTPUT"
    ROUTE = "ROUTE"
    AGGREGATE = "AGGREGATE"
    SEND_FEEDBACK = "SEND_FEEDBACK"


class EndpointType(str, Enum):
    REST = "REST"
    GRPC = "GRPC"


@dataclass(slots=True)
class Endpoint:
    """Remote-node endpoint (`proto/seldon_deployment.proto:135-145`)."""

    service_host: str = ""
    service_port: int = 0
    type: str = EndpointType.REST.value

    def to_dict(self) -> Dict[str, Any]:
        return {"service_host": self.service_host, "service_port": self.service_port,
                "type": self.type}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Endpoint":
        return cls(
            service_host=d.get("service_host", d.get("serviceHost", "")) or "",
            service_port=int(d.get("service_port", d.get("servicePort", 0)) or 0),
            type=d.get("type", EndpointType.REST.value) or EndpointType.REST.value,
        )


# Default methods per unit type, the reference's type -> method table
# (`engine/.../PredictorConfigBean.java:30-107`).
DEFAULT_METHODS: Dict[UnitType, List[UnitMethod]] = {
    UnitType.MODEL: [UnitMethod.TRANSFORM_INPUT, UnitMethod.SEND_FEEDBACK],
    UnitType.ROUTER: [UnitMethod.ROUTE, UnitMethod.SEND_FEEDBACK],
    UnitType.COMBINER: [UnitMethod.AGGREGATE],
    UnitType.TRANSFORMER: [UnitMethod.TRANSFORM_INPUT],
    UnitType.OUTPUT_TRANSFORMER: [UnitMethod.TRANSFORM_OUTPUT],
}


@dataclass
class PredictiveUnit:
    """One graph node (`proto/seldon_deployment.proto:87-133`)."""

    name: str
    children: List["PredictiveUnit"] = field(default_factory=list)
    type: Optional[UnitType] = None
    implementation: Optional[UnitImplementation] = None
    methods: Optional[List[UnitMethod]] = None
    endpoint: Optional[Endpoint] = None
    parameters: List[Parameter] = field(default_factory=list)
    model_uri: str = ""
    service_account_name: str = ""
    env_secret_ref_name: str = ""

    def resolved_methods(self) -> List[UnitMethod]:
        """Methods this unit takes part in: an explicit list wins, else by type."""
        if self.methods is not None:
            return self.methods
        if self.type is not None:
            return DEFAULT_METHODS.get(self.type, [])
        return []

    def parameters_dict(self) -> Dict[str, Any]:
        return {p.name: p.typed_value() for p in self.parameters}

    def walk(self):
        """This node and every descendant, pre-order."""
        yield self
        for c in self.children:
            yield from c.walk()

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name}
        if self.type is not None:
            d["type"] = self.type.value
        if self.implementation is not None:
            d["implementation"] = self.implementation.value
        if self.methods is not None:
            d["methods"] = [m.value for m in self.methods]
        if self.endpoint is not None:
            d["endpoint"] = self.endpoint.to_dict()
        if self.parameters:
            d["parameters"] = [p.to_dict() for p in self.parameters]
        if self.model_uri:
            d["modelUri"] = self.model_uri
        if self.service_account_name:
            d["serviceAccountName"] = self.service_account_name
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PredictiveUnit":
        if "name" not in d:
            raise SeldonError("PredictiveUnit requires a name", reason="BAD_GRAPH")
        try:
            utype = UnitType(d["type"]) if "type" in d else None
        except ValueError:
            raise SeldonError(f"Unknown unit type: {d['type']}", reason="BAD_GRAPH")
        try:
            impl = UnitImplementation(d["implementation"]) if "implementation" in d else None
        except ValueError:
            raise SeldonError(f"Unknown implementation: {d['implementation']}", reason="BAD_GRAPH")
        methods = [UnitMethod(m) for m in d["methods"]] if "methods" in d else None
        return cls(
            name=d["name"],
            children=[cls.from_dict(c) for c in d.get("children", []) or []],
            type=utype,
            implementation=impl,
            methods=methods,
            endpoint=Endpoint.from_dict(d["endpoint"]) if "endpoint" in d else None,
            parameters=[Parameter.from_dict(p) for p in d.get("parameters", []) or []],
            model_uri=d.get("modelUri", "") or "",
            service_account_name=d.get("serviceAccountName", "") or "",
            env_secret_ref_name=d.get("envSecretRefName", "") or "",
        )


@dataclass
class PredictorSpec:
    """One predictor: a graph plus replica and traffic settings
    (`proto/seldon_deployment.proto:47-85`)."""

    name: str
    graph: PredictiveUnit
    replicas: int = 1
    traffic: int = 0
    annotations: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    shadow: bool = False
    component_specs: List[Dict[str, Any]] = field(default_factory=list)
    svc_orch_spec: Dict[str, Any] = field(default_factory=dict)
    # `SeldonHpaSpec` (proto/seldon_deployment.proto:72-76)
    hpa_spec: Dict[str, Any] = field(default_factory=dict)
    # `Explainer` (proto/seldon_deployment.proto:45-51)
    explainer: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "graph": self.graph.to_dict(),
                             "replicas": self.replicas}
        if self.traffic:
            d["traffic"] = self.traffic
        if self.annotations:
            d["annotations"] = dict(self.annotations)
        if self.labels:
            d["labels"] = dict(self.labels)
        if self.shadow:
            d["shadow"] = True
        if self.component_specs:
            d["componentSpecs"] = self.component_specs
        if self.svc_orch_spec:
            d["svcOrchSpec"] = self.svc_orch_spec
        if self.hpa_spec:
            d["hpaSpec"] = self.hpa_spec
        if self.explainer:
            d["explainer"] = self.explainer
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PredictorSpec":
        if "graph" not in d:
            raise SeldonError("PredictorSpec requires a graph", reason="BAD_GRAPH")
        return cls(
            name=d.get("name", "default"),
            graph=PredictiveUnit.from_dict(d["graph"]),
            replicas=int(d.get("replicas", 1) or 1),
            traffic=int(d.get("traffic", 0) or 0),
            annotations=dict(d.get("annotations", {}) or {}),
            labels=dict(d.get("labels", {}) or {}),
            shadow=bool(d.get("shadow", False)),
            component_specs=list(d.get("componentSpecs", []) or []),
            svc_orch_spec=dict(d.get("svcOrchSpec", {}) or {}),
            hpa_spec=dict(d.get("hpaSpec", {}) or {}),
            explainer=dict(d.get("explainer", {}) or {}),
        )


@dataclass
class SeldonDeploymentSpec:
    """Whole-deployment spec (CRD `.spec`), `proto/seldon_deployment.proto:25-45`."""

    name: str
    predictors: List[PredictorSpec] = field(default_factory=list)
    annotations: Dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name,
                             "predictors": [p.to_dict() for p in self.predictors]}
        if self.annotations:
            d["annotations"] = dict(self.annotations)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SeldonDeploymentSpec":
        # a bare spec or a full CR ({"kind": "SeldonDeployment", "metadata",
        # "spec"})
        if d.get("kind") == "SeldonDeployment" or "spec" in d:
            name = d.get("metadata", {}).get("name", d.get("spec", {}).get("name", "seldon"))
            spec = d.get("spec", {})
        else:
            name = d.get("name", "seldon")
            spec = d
        return cls(
            name=name,
            predictors=[PredictorSpec.from_dict(p) for p in spec.get("predictors", []) or []],
            annotations=dict(spec.get("annotations", {}) or {}),
        )


def load_predictor_spec_from_env(env: Optional[Dict[str, str]] = None) -> Optional[PredictorSpec]:
    """A PredictorSpec the way the reference engine boots: base64 JSON in
    env ``ENGINE_PREDICTOR``, else the file ``ENGINE_PREDICTOR_FILE``
    (default ``./deploymentdef.json``) when it exists, else None
    (`engine/.../EnginePredictor.java:58-108`)."""
    env = env if env is not None else dict(os.environ)
    raw = env.get("ENGINE_PREDICTOR", "")
    if raw:
        return PredictorSpec.from_dict(json.loads(base64.b64decode(raw).decode("utf-8")))
    path = env.get("ENGINE_PREDICTOR_FILE", "./deploymentdef.json")
    if os.path.exists(path):
        with open(path) as f:
            return PredictorSpec.from_dict(json.load(f))
    return None


__all__ = ["DEFAULT_METHODS", "Endpoint", "EndpointType", "PredictiveUnit", "PredictorSpec",
           "SeldonDeploymentSpec", "UnitImplementation", "UnitMethod", "UnitType",
           "load_predictor_spec_from_env"]
