"""The user component contract, as far as the LLM server needs it.

Copied from ``seldon_core_tpu/components/component.py``: a component has a
``load()`` lifecycle hook and the reference's ``predict`` signature. The
graph-engine helpers (``client_*``) and the JAX fusion hook stay with the
JAX package until the one-model-predict slice ports the engine.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np


class SeldonComponent:
    """Base class for graph components (models, routers, transformers, combiners)."""

    def __init__(self, **kwargs: Any):
        pass

    def load(self) -> None:
        """Load model artifacts; called once before serving."""

    def predict(
        self, X: np.ndarray, names: Sequence[str], meta: Optional[Dict] = None
    ) -> Union[np.ndarray, List, str, bytes]:
        raise NotImplementedError


__all__ = ["SeldonComponent"]
