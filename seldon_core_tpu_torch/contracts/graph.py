"""Graph-spec enums of the port: only ``UnitImplementation``, which
``servers.make_prepackaged_server`` selects on. Copied from
``seldon_core_tpu/contracts/graph.py``; the graph spec itself (units,
endpoints, the engine) arrives with the engine slice."""

from __future__ import annotations

from enum import Enum


class UnitImplementation(str, Enum):
    """Built-in implementations (`proto/seldon_deployment.proto:102-113`).

    The *_SERVER values select prepackaged servers; JAX_SERVER maps to the
    port's ``TorchServer``.
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


__all__ = ["UnitImplementation"]
