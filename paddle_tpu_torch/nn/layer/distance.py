"""``PairwiseDistance`` (counterpart of
``paddle_tpu/nn/layer/distance.py``): the p-norm of ``x - y +
epsilon`` along the last axis, in f32."""
from __future__ import annotations

import torch

from ..layer_base import Layer

__all__ = ["PairwiseDistance"]


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = float(p)
        self.epsilon = float(epsilon)
        self.keepdim = keepdim

    def forward(self, x, y):
        d = (x - y).float() + self.epsilon
        if self.p == float("inf"):
            return d.abs().amax(dim=-1, keepdim=self.keepdim)
        return (d.abs() ** self.p).sum(dim=-1, keepdim=self.keepdim) \
            ** (1.0 / self.p)
