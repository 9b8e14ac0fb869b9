"""Device selection for the port: explicit, with no probe and no fallback.

``resolve_device(None)`` and ``resolve_device("cuda")`` name the card and
raise when PyTorch sees none; ``"cpu"`` is honoured only when asked for.
A serving process that silently landed on the CPU would answer every
request orders of magnitude slower while looking healthy, so the default
refuses instead of degrading.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Canonical ``torch.device`` for an entry point's ``device`` argument.

    None means ``"cuda"``. A CUDA device raises ``RuntimeError`` when
    ``torch.cuda.is_available()`` is false; any type other than cuda/cpu
    raises ``ValueError``."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is false: this "
                "port serves on an NVIDIA GPU and does not fall back to the "
                "CPU — pass device='cpu' explicitly to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: expected 'cuda' or 'cpu'")


__all__ = ["DEFAULT_DEVICE", "resolve_device"]
