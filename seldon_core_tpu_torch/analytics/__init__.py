"""Analytics units of the port: the bandit routers (``routers.py``), the
canary router and the shadow node (``canary.py``), the Mahalanobis outlier
detector they use (``outliers.py``) and the saliency explainer
(``explainers.py``). The isolation-forest, VAE and seq2seq detectors come
with the analytics slice."""

from seldon_core_tpu_torch.analytics.routers import EpsilonGreedy, ThompsonSampling
from seldon_core_tpu_torch.analytics.canary import CanaryRouter, ShadowNode
from seldon_core_tpu_torch.analytics.outliers import MahalanobisOutlierDetector
from seldon_core_tpu_torch.analytics.explainers import SaliencyExplainer

__all__ = [
    "CanaryRouter",
    "EpsilonGreedy",
    "MahalanobisOutlierDetector",
    "SaliencyExplainer",
    "ShadowNode",
    "ThompsonSampling",
]
