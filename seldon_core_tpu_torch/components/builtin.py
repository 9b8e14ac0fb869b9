"""Built-in graph units of the port, copied from
``seldon_core_tpu/components/builtin.py``: the reference engine's hard-coded
implementations (`engine/src/main/java/io/seldon/engine/predictors/
{SimpleModelUnit,SimpleRouterUnit,AverageCombinerUnit,RandomABTestUnit}.java`).

``SimpleModel`` and ``AverageCombiner`` answer on the host (they benchmark
the orchestrator and must not pay a device round trip a request) and expose
``torch_fn()``, their device twin, so a subtree of them and of other
``torch_fn`` units runs as one composed function on the engine's device
(``runtime/engine.py``).
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.components.metrics import create_counter, create_gauge, create_timer
from seldon_core_tpu_torch.contracts.graph import UnitImplementation


class SimpleModel(SeldonComponent):
    """Constant stub model: [[0.1, 0.9, 0.5]] a row and sample metrics;
    bytes and str payloads are echoed (`engine/.../SimpleModelUnit.java:33-64`)."""

    values = (0.1, 0.9, 0.5)
    classes = ("class0", "class1", "class2")

    def predict(self, X, names: Sequence[str], meta: Optional[Dict] = None):
        if isinstance(X, (bytes, bytearray, str)) or X is None:
            return X
        arr = np.asarray(X, dtype=np.float32)  # still rejects non-numeric payloads
        rows = arr.shape[0] if arr.ndim > 1 else 1
        return np.tile(np.asarray(self.values, dtype=np.float32), (rows, 1))

    def torch_fn(self):
        return self._fn, None

    @staticmethod
    def _fn(params: Any, x: torch.Tensor) -> torch.Tensor:
        # the host path's rows: a 1-D payload is one sample
        rows = x.shape[0] if x.ndim >= 2 else 1
        return x.new_tensor(SimpleModel.values, dtype=torch.float32).repeat(rows, 1)

    def class_names(self) -> List[str]:
        return list(self.classes)

    def metrics(self):
        return [create_counter("mycounter", 1.0), create_gauge("mygauge", 100.0),
                create_timer("mytimer", 20.6)]


class SimpleRouter(SeldonComponent):
    """Always branch 0 (`engine/.../SimpleRouterUnit.java`)."""

    def route(self, X, names: Sequence[str]) -> int:
        return 0


class RandomABTest(SeldonComponent):
    """Uniform-random branch choice (`engine/.../RandomABTestUnit.java`),
    from Python's ``random.Random(seed)`` as in the JAX package."""

    def __init__(self, ratioA: float = 0.5, n_branches: int = 2, seed: Optional[int] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.ratio_a = float(ratioA)
        self.n_branches = int(n_branches)
        self._rng = random.Random(seed)

    def route(self, X, names: Sequence[str]) -> int:
        if self.n_branches == 2:
            return 0 if self._rng.random() < self.ratio_a else 1
        return self._rng.randrange(self.n_branches)


class AverageCombiner(SeldonComponent):
    """Element-wise mean of the children's outputs
    (`engine/.../AverageCombinerUnit.java`): float64 on the host; its
    ``torch_fn`` means the stacked outputs on the device in their dtype."""

    def aggregate(self, Xs: Sequence[np.ndarray], names: Sequence[Sequence[str]]):
        if not Xs:
            raise ValueError("AverageCombiner requires at least one input")
        shapes = {np.asarray(x).shape for x in Xs}
        if len(shapes) != 1:
            raise ValueError(f"AverageCombiner inputs must share a shape, got {sorted(shapes)}")
        return np.stack([np.asarray(x, dtype=np.float64) for x in Xs]).mean(axis=0)

    def torch_fn(self):
        return self._fn, None

    @staticmethod
    def _fn(params: Any, stacked: torch.Tensor) -> torch.Tensor:
        return stacked.mean(dim=0)


def make_builtin(implementation: UnitImplementation,
                 parameters: Optional[Dict[str, Any]] = None,
                 device: Any = None) -> SeldonComponent:
    """A built-in unit for a graph spec's implementation; ValueError when
    the implementation is not a built-in (a prepackaged server). The
    Mahalanobis, VAE and seq2seq detectors keep their state on ``device``
    (the engine's); the isolation forest is sklearn on the host."""
    parameters = parameters or {}
    if implementation == UnitImplementation.SIMPLE_MODEL:
        return SimpleModel()
    if implementation == UnitImplementation.SIMPLE_ROUTER:
        return SimpleRouter()
    if implementation == UnitImplementation.RANDOM_ABTEST:
        return RandomABTest(**parameters)
    if implementation == UnitImplementation.AVERAGE_COMBINER:
        return AverageCombiner()
    if implementation in (UnitImplementation.EPSILON_GREEDY, UnitImplementation.THOMPSON_SAMPLING):
        from seldon_core_tpu_torch.analytics.routers import EpsilonGreedy, ThompsonSampling

        cls = (EpsilonGreedy if implementation == UnitImplementation.EPSILON_GREEDY
               else ThompsonSampling)
        return cls(**parameters)
    if implementation == UnitImplementation.ISOLATION_FOREST_OD:
        from seldon_core_tpu_torch.analytics.outliers import IsolationForestOutlierDetector

        return IsolationForestOutlierDetector(**parameters)
    on_device = {
        UnitImplementation.MAHALANOBIS_OD: "MahalanobisOutlierDetector",
        UnitImplementation.VAE_OD: "VAEOutlierDetector",
        UnitImplementation.SEQ2SEQ_OD: "Seq2SeqOutlierDetector",
    }
    if implementation in on_device:
        from seldon_core_tpu_torch.analytics import outliers

        return getattr(outliers, on_device[implementation])(device=device, **parameters)
    raise ValueError(f"No in-process builtin for implementation {implementation}")


__all__ = ["AverageCombiner", "RandomABTest", "SimpleModel", "SimpleRouter", "make_builtin"]
