"""MLflow prepackaged server of the port, copied from
``seldon_core_tpu/servers/mlflowserver.py`` (the reference's
`servers/mlflowserver/mlflowserver/MLFlowServer.py:15-48`): a pyfunc model
directory, predicting on a pandas DataFrame. Host only. ``load()`` imports
mlflow (and pandas) and raises naming the one that is absent.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from seldon_core_tpu_torch import storage
from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.payload import SeldonError


class MLFlowServer(SeldonComponent):
    def __init__(self, model_uri: str = "", **kwargs):
        super().__init__(**kwargs)
        self.model_uri = model_uri
        self.ready = False
        self._model = None

    def load(self) -> None:
        if self.ready:
            return
        for package in ("mlflow", "pandas"):
            try:
                __import__(package)
            except ImportError as e:
                raise SeldonError(f"MLFLOW_SERVER requires the {package} package, which is "
                                  f"not installed", status_code=500) from e
        import mlflow.pyfunc

        self._model = mlflow.pyfunc.load_model(storage.download(self.model_uri))
        self.ready = True

    def predict(self, X: np.ndarray, names: Sequence[str], meta: Optional[Dict] = None):
        if not self.ready:
            self.load()
        import pandas as pd

        df = pd.DataFrame(np.asarray(X), columns=list(names) if names else None)
        return np.asarray(self._model.predict(df))
