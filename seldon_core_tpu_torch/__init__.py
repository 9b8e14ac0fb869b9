"""PyTorch/CUDA port of seldon_core_tpu for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here keeps
its counterpart's name, so ``seldon_core_tpu_torch.models.transformer`` is
the port of ``seldon_core_tpu.models.transformer``. This package imports
``torch`` and never ``jax``, and nothing of ``seldon_core_tpu`` — what it
needs from a pure-host module there is copied, not imported.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``
(``device.resolve_device``): without a card it raises, and it runs on the
CPU only when the caller passes ``device="cpu"``, as the tests do.
"""

__version__ = "0.1.0"
