"""Dropout and Embedding (counterpart of ``paddle_tpu/nn/layer/common.py``)."""
from __future__ import annotations

import torch
from torch import nn

from .. import initializer as I

__all__ = ["Dropout", "Embedding"]


class Dropout(nn.Module):
    """Inverted dropout; the identity in eval mode or at p == 0."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        return nn.functional.dropout(x, self.p, training=True)


class Embedding(nn.Module):
    """Lookup table ``weight [num_embeddings, embedding_dim]``."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_init: I.Initializer = None, *, device, dtype,
                 generator):
        super().__init__()
        self.weight = I.make_parameter(
            (num_embeddings, embedding_dim),
            weight_init or I.Normal(0.0, 1.0), device=device, dtype=dtype,
            generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return nn.functional.embedding(ids, self.weight)
