"""Control plane of the port (``seldon_core_tpu/controlplane/``):
defaulting and validation of SeldonDeployment CRs, manifest rendering for
NVIDIA GPU nodes, the helm-chart subset renderer, the operator's reconcile
loop, and the signal-driven autoscaler over the port's replica fleet."""

from seldon_core_tpu_torch.controlplane.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    ReplicaSignals,
    decide_rebalance,
    decide_scale,
)
from seldon_core_tpu_torch.controlplane.validate import default_deployment, validate_deployment
from seldon_core_tpu_torch.controlplane.render import render_manifests

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "ReplicaSignals",
    "decide_rebalance",
    "decide_scale",
    "default_deployment",
    "validate_deployment",
    "render_manifests",
]
