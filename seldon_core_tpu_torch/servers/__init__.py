"""Prepackaged servers of the port.

``make_prepackaged_server`` is the port of ``seldon_core_tpu.servers``'s
selector (the reference's `servers/{sklearnserver,xgboostserver,
mlflowserver,tfserving}`, chosen by ``implementation`` + ``modelUri``):
``JAX_SERVER`` gives ``TorchServer`` (the counterpart of ``JAXServer``, on
the engine's device); ``SKLEARN_SERVER``, ``XGBOOST_SERVER``,
``MLFLOW_SERVER`` and ``TENSORFLOW_SERVER`` (a proxy to TF-Serving) are
host-only copies of the JAX package's, each importing its library at
``load()`` and raising, naming it, where it is absent.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.graph import UnitImplementation
from seldon_core_tpu_torch.contracts.payload import SeldonError


def make_prepackaged_server(implementation: UnitImplementation, model_uri: str,
                            parameters: Optional[Dict[str, Any]] = None,
                            device: Optional[str] = None) -> SeldonComponent:
    parameters = parameters or {}
    if implementation == UnitImplementation.JAX_SERVER:
        from seldon_core_tpu_torch.servers.torchserver import TorchServer

        return TorchServer(model_uri=model_uri, device=device, **parameters)
    if implementation == UnitImplementation.SKLEARN_SERVER:
        from seldon_core_tpu_torch.servers.sklearnserver import SKLearnServer

        return SKLearnServer(model_uri=model_uri, **parameters)
    if implementation == UnitImplementation.XGBOOST_SERVER:
        from seldon_core_tpu_torch.servers.xgboostserver import XGBoostServer

        return XGBoostServer(model_uri=model_uri, **parameters)
    if implementation == UnitImplementation.MLFLOW_SERVER:
        from seldon_core_tpu_torch.servers.mlflowserver import MLFlowServer

        return MLFlowServer(model_uri=model_uri, **parameters)
    if implementation == UnitImplementation.TENSORFLOW_SERVER:
        from seldon_core_tpu_torch.servers.tfproxy import TFServingProxy

        return TFServingProxy(model_uri=model_uri, **parameters)
    raise SeldonError(
        f"No prepackaged server for implementation {implementation}", reason="BAD_GRAPH"
    )


__all__ = ["make_prepackaged_server"]
