"""Prepackaged servers of the port.

``make_prepackaged_server`` is the port of ``seldon_core_tpu.servers``'s
selector: ``UnitImplementation.JAX_SERVER`` gives ``TorchServer``, the
counterpart of ``JAXServer``. The other prepackaged servers (sklearn,
xgboost, mlflow, the TF-Serving proxy) arrive with later slices.
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
    if implementation in (UnitImplementation.SKLEARN_SERVER, UnitImplementation.XGBOOST_SERVER,
                          UnitImplementation.MLFLOW_SERVER,
                          UnitImplementation.TENSORFLOW_SERVER):
        raise NotImplementedError(f"{implementation.value} arrives with a later slice of the "
                                  f"port (only JAX_SERVER -> TorchServer is ported)")
    raise SeldonError(
        f"No prepackaged server for implementation {implementation}", reason="BAD_GRAPH"
    )


__all__ = ["make_prepackaged_server"]
