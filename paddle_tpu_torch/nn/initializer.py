"""Parameter initializers (counterpart of ``paddle_tpu/nn/initializer.py``,
``Normal`` and ``XavierUniform`` only).

An initializer fills a tensor in place from an explicit generator; the
JAX package draws from its global key instead, so the two packages give
different numbers for the same seed (tests load one set of weights into
both through ``models.convert``).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["Initializer", "Normal", "XavierUniform", "make_parameter"]


class Initializer:
    def __call__(self, t: torch.Tensor, generator: torch.Generator
                 ) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def _fans(shape: Sequence[int]):
        """(fan_in, fan_out) of a vector or of a weight in the JAX
        layout ``[in, out]``."""
        shape = tuple(shape)
        if len(shape) == 1:
            return shape[0], shape[0]
        if len(shape) == 2:
            return shape[0], shape[1]
        raise ValueError(f"fans of a {len(shape)}-D weight are not defined "
                         f"here: {shape}")


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, t, generator):
        return t.normal_(self.mean, self.std, generator=generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, t, generator):
        fi, fo = self._fans(t.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return t.uniform_(-limit, limit, generator=generator)


def make_parameter(shape, init, *, device, dtype, generator
                   ) -> torch.nn.Parameter:
    """A parameter of ``shape`` on ``device``: ``init`` is an
    Initializer, or a float to fill with (0.0 for biases, 1.0 for norm
    scales)."""
    t = torch.empty(tuple(shape), device=device, dtype=dtype)
    if isinstance(init, Initializer):
        init(t, generator)
    else:
        t.fill_(float(init))
    return torch.nn.Parameter(t)
