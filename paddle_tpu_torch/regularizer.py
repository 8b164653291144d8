"""Weight-decay regularizers (counterpart of ``paddle_tpu/regularizer.py``):
``apply(param, grad)`` returns the decayed gradient, which the optimizer
update then consumes."""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def apply(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def coeff(self):
        return self._coeff


class L1Decay(WeightDecayRegularizer):
    """``g + coeff * sign(p)``."""

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def apply(self, p, g):
        return g + self._coeff * torch.sign(p)

    def __repr__(self):
        return f"L1Decay({self._coeff})"


class L2Decay(WeightDecayRegularizer):
    """``g + coeff * p``."""

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def apply(self, p, g):
        return g + self._coeff * p

    def __repr__(self):
        return f"L2Decay({self._coeff})"
