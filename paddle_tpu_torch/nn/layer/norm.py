"""LayerNorm (counterpart of ``paddle_tpu/nn/layer/norm.py``)."""
from __future__ import annotations

import torch
from torch import nn

from .. import initializer as I

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """Normalizes over the last dimension in f32 and casts back to the
    input dtype, as the JAX ``layer_norm`` does."""

    def __init__(self, normalized_shape: int, epsilon: float = 1e-5, *,
                 device, dtype):
        super().__init__()
        self.normalized_shape = (int(normalized_shape),)
        self.epsilon = float(epsilon)
        self.weight = I.make_parameter(self.normalized_shape, 1.0,
                                       device=device, dtype=dtype,
                                       generator=None)
        self.bias = I.make_parameter(self.normalized_shape, 0.0,
                                     device=device, dtype=dtype,
                                     generator=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = nn.functional.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.epsilon)
        return out.to(x.dtype)
