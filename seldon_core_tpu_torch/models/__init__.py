"""Model families of the port (torch ``nn.Module``s in the JAX weight layout)."""

from seldon_core_tpu_torch.models.registry import get_model, register_model

__all__ = ["get_model", "register_model"]
