"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``)."""
from __future__ import annotations

import torch

__all__ = ["gelu"]


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU; ``approximate=True`` is the tanh form GPT's MLP uses."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")
