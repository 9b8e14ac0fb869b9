"""Explainer components: the port of ``seldon_core_tpu/analytics/explainers.py``.

The CRD's per-predictor ``explainer`` slot (``controlplane/render.py``
renders its Deployment and Service) deploys a service that answers "why
did the model predict this". The served model is a differentiable forward,
so an attribution is one input gradient: no surrogate model, no sampling
loop.

``SaliencyExplainer`` loads the SAME checkpoint as the model it explains,
through ``TorchServer(...).torch_fn()`` (the cast and quantized forward
included), and serves attributions through the component contract:
``predict(X)`` returns gradient x input per feature, or integrated
gradients along the zero-baseline path when ``steps > 1``. On the card the
gradient runs through the kernels' own backward: K3's
(``ops/fused_resnet``) in a folded ResNet's identity chains, K4's
(``ops/int8_matmul``) in an int8 checkpoint's products; both are plain
PyTorch, the same code the CPU runs.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from seldon_core_tpu_torch.codec.staging import stage_to_device
from seldon_core_tpu_torch.components.component import SeldonComponent
from seldon_core_tpu_torch.contracts.payload import SeldonError
from seldon_core_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


class SaliencyExplainer(SeldonComponent):
    """Gradient-based attribution for a ``TorchServer`` checkpoint, on
    ``device`` (default "cuda": raises without a card).

    Parameters: model_uri (the checkpoint to explain), target ("max" = the
    largest output, or a class index), steps (1 = plain grad x input; > 1 =
    integrated gradients at alphas ``linspace(1/steps, 1, steps)``, their
    gradients summed in that order, then divided by ``steps``, as the JAX
    package's scan does), batch_buckets (default: the server's)."""

    def __init__(self, model_uri: str = "", target: Any = "max", steps: int = 1,
                 batch_buckets: Any = None, device: Optional[str] = None, **kwargs: Any):
        super().__init__(**kwargs)
        self.model_uri = model_uri
        self.target = target
        self.steps = int(steps)
        self.batch_buckets = tuple(batch_buckets) if batch_buckets else None
        self.device = resolve_device(device)
        self.ready = False
        self._fn = self._module = None

    def load(self) -> None:
        if self.ready:
            return
        from seldon_core_tpu_torch.servers.torchserver import TorchServer

        server = TorchServer(model_uri=self.model_uri, device=self.device)
        self._fn, self._module = server.torch_fn()   # loads; the public composition surface
        if self.batch_buckets is None:
            self.batch_buckets = server.batch_buckets
        self._input_dtype = server.input_dtype
        self.ready = True
        logger.info("SaliencyExplainer ready over %s (steps=%d) on %s", self.model_uri,
                    self.steps, self.device)

    def _scalar(self, x: torch.Tensor) -> torch.Tensor:
        out = self._fn(self._module, x)
        target = self.target
        if isinstance(target, int) or (isinstance(target, str) and target.isdigit()):
            picked = out[..., int(target)]
        else:   # "max": the predicted class's logit or probability
            picked = out.amax(dim=-1)
        return picked.sum()

    def gradient(self, x: torch.Tensor) -> torch.Tensor:
        """d(target output summed over the batch) / dx, x's dtype."""
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            return torch.autograd.grad(self._scalar(xg), xg)[0]

    def attribute(self, x: torch.Tensor) -> torch.Tensor:
        """The attribution of a staged batch ``x`` on the device."""
        if self.steps <= 1:
            return self.gradient(x) * x
        total = torch.zeros_like(x)
        for a in torch.linspace(1.0 / self.steps, 1.0, self.steps, dtype=torch.float32):
            total = total + self.gradient(x * a.item())
        return (total / self.steps) * x

    def predict(self, X, names: Sequence[str], meta: Optional[Dict] = None) -> np.ndarray:
        if not self.ready:
            self.load()
        # gradients are taken wrt the model INPUT: the checkpoint must take
        # continuous features (an int-input model, e.g. token ids, has no
        # meaningful input gradient); numeric requests cast to that dtype
        if not np.issubdtype(self._input_dtype, np.floating):
            raise SeldonError(
                f"saliency needs a float-input model, checkpoint declares "
                f"{self._input_dtype}", status_code=400,
            )
        raw = np.asarray(X)
        if not np.issubdtype(raw.dtype, np.number):
            raise SeldonError("saliency explanations need numeric inputs", status_code=400)
        arr = raw.astype(self._input_dtype, copy=False)
        # the server's bucketing: one set of batch shapes for the kernels
        x, true_n = stage_to_device(arr, self.device, pad=True, buckets=self.batch_buckets)
        return self.attribute(x)[:true_n].float().cpu().numpy()

    def tags(self) -> Dict[str, Any]:
        return {"explainer": "saliency", "steps": self.steps, "target": str(self.target)}


__all__ = ["SaliencyExplainer"]
