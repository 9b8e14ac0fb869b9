"""sklearn prepackaged server of the port, copied from
``seldon_core_tpu/servers/sklearnserver.py`` (the reference's
`servers/sklearnserver/sklearnserver/SKLearnServer.py:15-44`): loads
``model.joblib`` from ``model_uri`` through the port's ``storage`` and
answers with ``predict_proba`` (the default) or ``predict``. Host only.
``load()`` imports joblib and raises naming it where it is absent.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np

from seldon_core_tpu_torch import storage
from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.payload import SeldonError

logger = logging.getLogger(__name__)

JOBLIB_FILE = "model.joblib"


class SKLearnServer(SeldonComponent):
    def __init__(self, model_uri: str = "", method: str = "predict_proba", **kwargs):
        super().__init__(**kwargs)
        self.model_uri = model_uri
        self.method = method
        self.ready = False
        self._model = None

    def load(self) -> None:
        if self.ready:
            return
        try:
            import joblib
        except ImportError as e:
            raise SeldonError("SKLEARN_SERVER requires the joblib package (and scikit-learn), "
                              "which is not installed", status_code=500) from e
        path = storage.download(self.model_uri)
        if os.path.isdir(path):
            path = os.path.join(path, JOBLIB_FILE)
        if not os.path.exists(path):
            raise SeldonError(f"sklearn model file not found: {path}", status_code=500)
        self._model = joblib.load(path)
        self.ready = True
        logger.info("loaded sklearn model from %s", path)

    def predict(self, X: np.ndarray, names: Sequence[str], meta: Optional[Dict] = None):
        if not self.ready:
            self.load()
        if self.method == "predict_proba":
            return self._model.predict_proba(X)
        return self._model.predict(X)
