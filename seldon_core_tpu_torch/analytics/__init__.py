"""Analytics units of the port: the bandit routers (``routers.py``), the
canary router and the shadow node (``canary.py``), the outlier detectors
(``outliers.py``: Mahalanobis, isolation forest, VAE, seq2seq) and the
saliency explainer (``explainers.py``)."""

from seldon_core_tpu_torch.analytics.routers import EpsilonGreedy, ThompsonSampling
from seldon_core_tpu_torch.analytics.canary import CanaryRouter, ShadowNode
from seldon_core_tpu_torch.analytics.outliers import (IsolationForestOutlierDetector,
                                                      MahalanobisOutlierDetector,
                                                      Seq2SeqOutlierDetector, VAEOutlierDetector)
from seldon_core_tpu_torch.analytics.explainers import SaliencyExplainer

__all__ = [
    "CanaryRouter",
    "EpsilonGreedy",
    "IsolationForestOutlierDetector",
    "MahalanobisOutlierDetector",
    "SaliencyExplainer",
    "Seq2SeqOutlierDetector",
    "ShadowNode",
    "ThompsonSampling",
    "VAEOutlierDetector",
]
