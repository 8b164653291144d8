"""Device resolution (counterpart of ``paddle_tpu/device.py``).

The port runs on the card unless the caller asks for the CPU: ``None``
means CUDA, and with no CUDA device that raises instead of quietly
running on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "same_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> the current CUDA device; raises when CUDA is absent.
    An explicit ``"cpu"`` (what the CPU tests pass) gives the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: paddle_tpu_torch runs on the GPU unless "
                "device='cpu' is passed explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """Equality that treats ``cuda`` and ``cuda:<current>`` as one."""
    def norm(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return norm(a) == norm(b)
