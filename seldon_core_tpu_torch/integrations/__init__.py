"""External inference-server integrations of the port: the SageMaker proxy
(``sagemaker.py``); the TF-Serving proxy is ``servers/tfproxy.py``."""

from seldon_core_tpu_torch.integrations.sagemaker import SageMakerProxy

__all__ = ["SageMakerProxy"]
