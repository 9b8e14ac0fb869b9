"""XGBoost prepackaged server of the port, copied from
``seldon_core_tpu/servers/xgboostserver.py`` (the reference's
`servers/xgboostserver/xgboostserver/XGBoostServer.py:10-26`): a booster
from ``model.bst`` under ``model_uri``. Host only. ``load()`` imports
xgboost and raises naming it where it is absent, so a spec naming the
server still parses.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from seldon_core_tpu_torch import storage
from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.payload import SeldonError

BOOSTER_FILE = "model.bst"


class XGBoostServer(SeldonComponent):
    def __init__(self, model_uri: str = "", **kwargs):
        super().__init__(**kwargs)
        self.model_uri = model_uri
        self.ready = False
        self._booster = None

    def load(self) -> None:
        if self.ready:
            return
        try:
            import xgboost as xgb
        except ImportError as e:
            raise SeldonError("XGBOOST_SERVER requires the xgboost package, which is not "
                              "installed", status_code=500) from e
        path = storage.download(self.model_uri)
        if os.path.isdir(path):
            path = os.path.join(path, BOOSTER_FILE)
        self._booster = xgb.Booster(model_file=path)
        self._xgb = xgb
        self.ready = True

    def predict(self, X: np.ndarray, names: Sequence[str], meta: Optional[Dict] = None):
        if not self.ready:
            self.load()
        return self._booster.predict(self._xgb.DMatrix(X))
