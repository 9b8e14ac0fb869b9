"""Analytics units of the port: the bandit routers (``routers.py``), the
canary router and the shadow node (``canary.py``), and the Mahalanobis
outlier detector they use (``outliers.py``). The isolation-forest, VAE and
seq2seq detectors and the explainers come with the analytics slice."""

from seldon_core_tpu_torch.analytics.routers import EpsilonGreedy, ThompsonSampling
from seldon_core_tpu_torch.analytics.canary import CanaryRouter, ShadowNode
from seldon_core_tpu_torch.analytics.outliers import MahalanobisOutlierDetector

__all__ = [
    "CanaryRouter",
    "EpsilonGreedy",
    "MahalanobisOutlierDetector",
    "ShadowNode",
    "ThompsonSampling",
]
