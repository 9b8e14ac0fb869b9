"""Defaulting + validation webhooks' logic of the port, as pure functions,
copied from ``seldon_core_tpu/controlplane/validate.py`` (the same problem
strings, the same implementations accepted).

The reference performs these in the operator's defaulting/validating webhook
(SURVEY.md §2.8: "defaulting/validating webhook"; invalid specs are rejected
before rollout — testing/scripts/test_bad_graphs.py). Same contract here:
``default_deployment`` fills the fields the webhook would, and
``validate_deployment`` returns every problem found (empty list = valid);
``require_valid`` raises SeldonError for API use.
"""

from __future__ import annotations

import re
from typing import List

from seldon_core_tpu_torch.contracts.graph import (
    PredictiveUnit,
    SeldonDeploymentSpec,
    UnitImplementation,
    UnitType,
)
from seldon_core_tpu_torch.contracts.payload import SeldonError
from seldon_core_tpu_torch.controlplane.quantity import validate_resources

_NAME_RE = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")  # RFC 1123 label

# implementations the engine can run without an endpoint or model_uri
_SELF_CONTAINED = {
    UnitImplementation.SIMPLE_MODEL,
    UnitImplementation.SIMPLE_ROUTER,
    UnitImplementation.RANDOM_ABTEST,
    UnitImplementation.AVERAGE_COMBINER,
    UnitImplementation.EPSILON_GREEDY,
    UnitImplementation.THOMPSON_SAMPLING,
    UnitImplementation.MAHALANOBIS_OD,
    UnitImplementation.ISOLATION_FOREST_OD,
    UnitImplementation.VAE_OD,
    UnitImplementation.SEQ2SEQ_OD,
}
_SERVER_IMPLS = {
    UnitImplementation.SKLEARN_SERVER,
    UnitImplementation.XGBOOST_SERVER,
    UnitImplementation.TENSORFLOW_SERVER,
    UnitImplementation.MLFLOW_SERVER,
    UnitImplementation.JAX_SERVER,
}


def default_deployment(sdep: SeldonDeploymentSpec) -> SeldonDeploymentSpec:
    """Fill the fields the reference's defaulting webhook would: predictor
    names, replicas>=1, and traffic weights when none are set (100 for a lone
    predictor; an even split across non-shadow predictors otherwise, so the
    rendered VirtualService never routes 0% everywhere)."""
    for i, p in enumerate(sdep.predictors):
        if not p.name:
            p.name = f"predictor-{i}"
        if p.replicas < 1:
            p.replicas = 1
    live = [p for p in sdep.predictors if not p.shadow]
    if live and not any(p.traffic for p in live):
        share, rem = divmod(100, len(live))
        for i, p in enumerate(live):
            p.traffic = share + (1 if i < rem else 0)
    return sdep


def _validate_unit(unit: PredictiveUnit, path: str, problems: List[str], seen: set) -> None:
    if not unit.name:
        problems.append(f"{path}: unit has no name")
    elif unit.name in seen:
        problems.append(f"{path}: duplicate unit name {unit.name!r}")
    else:
        seen.add(unit.name)

    needs_uri = (unit.implementation in _SERVER_IMPLS
                 and unit.implementation != UnitImplementation.TENSORFLOW_SERVER)
    runnable = (
        (unit.implementation in _SELF_CONTAINED)
        or (unit.implementation in _SERVER_IMPLS and (unit.model_uri or not needs_uri))
        or (unit.endpoint is not None and unit.endpoint.service_host)
        or unit.implementation in (None, UnitImplementation.UNKNOWN_IMPLEMENTATION)
        # custom units resolve by name at engine build; their validity is a
        # deploy-time concern (componentSpecs must supply the container)
    )
    if needs_uri and not unit.model_uri:
        problems.append(f"{path}: {unit.implementation.value} requires modelUri")
    if not runnable:
        problems.append(f"{path}: unit {unit.name!r} is not resolvable")

    if unit.type == UnitType.ROUTER and len(unit.children) < 1:
        problems.append(f"{path}: ROUTER {unit.name!r} needs at least one child")
    if unit.type == UnitType.COMBINER and len(unit.children) < 1:
        problems.append(f"{path}: COMBINER {unit.name!r} needs at least one child")
    if unit.type in (UnitType.TRANSFORMER, UnitType.OUTPUT_TRANSFORMER) and len(unit.children) > 1:
        problems.append(
            f"{path}: {unit.type.value} {unit.name!r} must have at most one child (got {len(unit.children)})"
        )
    if unit.type == UnitType.MODEL and len(unit.children) > 1:
        problems.append(f"{path}: MODEL {unit.name!r} cannot fan out to {len(unit.children)} children")

    for c in unit.children:
        _validate_unit(c, f"{path}.{unit.name}", problems, seen)


def validate_deployment(sdep: SeldonDeploymentSpec) -> List[str]:
    problems: List[str] = []
    if not _NAME_RE.match(sdep.name or ""):
        problems.append(f"deployment name {sdep.name!r} is not a valid DNS label")
    if not sdep.predictors:
        problems.append("deployment has no predictors")

    names = set()
    total_traffic = 0
    any_traffic = False
    for p in sdep.predictors:
        path = f"predictor[{p.name}]"
        if not _NAME_RE.match(p.name or ""):
            problems.append(f"{path}: name is not a valid DNS label")
        if p.name in names:
            problems.append(f"{path}: duplicate predictor name")
        names.add(p.name)
        if p.replicas < 1:
            problems.append(f"{path}: replicas must be >= 1")
        if p.traffic:
            any_traffic = True
            if not 0 <= p.traffic <= 100:
                problems.append(f"{path}: traffic {p.traffic} outside [0, 100]")
        if not p.shadow:
            total_traffic += p.traffic
        if p.hpa_spec:
            mn = p.hpa_spec.get("minReplicas", 1)
            mx = p.hpa_spec.get("maxReplicas")
            if mx is None:
                problems.append(f"{path}: hpaSpec needs maxReplicas")
            elif mn > mx:
                problems.append(f"{path}: hpaSpec minReplicas {mn} > maxReplicas {mx}")
        # k8s Quantity grammar for every resources block the CR carries
        # (svcOrchSpec and componentSpecs containers — the surface the
        # reference's vendored QuantityUtils JSON parser accepted)
        if p.svc_orch_spec.get("resources"):
            validate_resources(p.svc_orch_spec["resources"], f"{path}.svcOrchSpec.resources", problems)
        for ci, cs in enumerate(p.component_specs):
            spec = cs.get("spec", cs)
            for cj, container in enumerate(spec.get("containers", []) or []):
                if container.get("resources"):
                    validate_resources(
                        container["resources"],
                        f"{path}.componentSpecs[{ci}].containers[{cj}].resources",
                        problems,
                    )
        _validate_unit(p.graph, path, problems, seen=set())

    if any_traffic and len([p for p in sdep.predictors if not p.shadow]) > 1 and total_traffic != 100:
        problems.append(f"traffic weights across predictors sum to {total_traffic}, expected 100")
    return problems


def require_valid(sdep: SeldonDeploymentSpec) -> SeldonDeploymentSpec:
    sdep = default_deployment(sdep)
    problems = validate_deployment(sdep)
    if problems:
        raise SeldonError("; ".join(problems), reason="BAD_GRAPH", status_code=400)
    return sdep
