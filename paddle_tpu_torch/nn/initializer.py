"""Parameter initializers (counterpart of ``paddle_tpu/nn/initializer.py``).

An initializer fills a tensor in place from an explicit generator; the
JAX package draws from its global key instead, so the two packages give
different numbers for the same seed (tests load one set of weights into
both through ``Layer.set_state_dict`` or ``models.convert``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal",
           "Uniform", "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Assign", "Bilinear", "calculate_gain",
           "set_global_initializer", "get_global_initializer",
           "make_parameter"]

_global_weight_init = None
_global_bias_init = None


class Initializer:
    def __call__(self, t: torch.Tensor, generator: torch.Generator
                 ) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def _fans(shape: Sequence[int]):
        """(fan_in, fan_out) of a vector, of a weight in the JAX layout
        ``[in, out]``, or of a conv kernel ``[out_c, in_c, *spatial]``."""
        shape = tuple(shape)
        if len(shape) == 0:
            return 1, 1
        if len(shape) == 1:
            return shape[0], shape[0]
        if len(shape) == 2:
            return shape[0], shape[1]
        receptive = int(np.prod(shape[2:]))
        return shape[1] * receptive, shape[0] * receptive


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, t, generator=None):
        return t.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, t, generator):
        return t.normal_(self.mean, self.std, generator=generator)


class TruncatedNormal(Initializer):
    """Normal truncated to two standard deviations."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, t, generator):
        with torch.no_grad():
            buf = torch.empty(t.shape, dtype=torch.float32, device=t.device)
            buf.normal_(0.0, 1.0, generator=generator)
            bad = buf.abs() > 2.0
            # redraw the tails until every value lies within 2 sigma
            while bool(bad.any()):
                fresh = torch.empty_like(buf).normal_(0.0, 1.0,
                                                      generator=generator)
                buf = torch.where(bad, fresh, buf)
                bad = buf.abs() > 2.0
            return t.copy_(buf * self.std + self.mean)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, t, generator):
        return t.uniform_(self.low, self.high, generator=generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, t, generator):
        fi, fo = self._fans(t.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return t.normal_(0.0, std, generator=generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, t, generator):
        fi, fo = self._fans(t.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return t.uniform_(-limit, limit, generator=generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, t, generator):
        fi = self.fan_in if self.fan_in is not None else self._fans(
            t.shape)[0]
        std = calculate_gain(self.nonlinearity,
                             self.negative_slope) / math.sqrt(fi)
        return t.normal_(0.0, std, generator=generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, t, generator):
        fi = self.fan_in if self.fan_in is not None else self._fans(
            t.shape)[0]
        limit = calculate_gain(self.nonlinearity,
                               self.negative_slope) * math.sqrt(3.0 / fi)
        return t.uniform_(-limit, limit, generator=generator)


class Assign(Initializer):
    """The values of a given array, list or tensor."""

    def __init__(self, value):
        self.value = value

    def __call__(self, t, generator=None):
        v = self.value
        v = v.detach() if torch.is_tensor(v) else torch.as_tensor(
            np.asarray(v))
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"Assign initializer shape {tuple(v.shape)} != "
                             f"param shape {tuple(t.shape)}")
        return t.copy_(v)


class Bilinear(Initializer):
    """The bilinear upsampling kernel of a transposed conv
    ``[C_out, C_in, K, K]``."""

    def __call__(self, t, generator=None):
        shape = tuple(t.shape)
        if len(shape) != 4 or shape[2] != shape[3]:
            raise ValueError("Bilinear expects [C_out, C_in, K, K]")
        k = shape[3]
        f = math.ceil(k / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        filt = 1 - np.abs(np.arange(k) / f - c)
        w = np.zeros(shape, dtype=np.float32)
        for i in range(shape[0]):
            w[i, i % shape[1]] = filt[:, None] * filt[None, :]
        return t.copy_(torch.from_numpy(w))


def calculate_gain(nonlinearity: str, param: Optional[float] = None) -> float:
    recommended = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "selu": 3.0 / 4,
    }
    if nonlinearity == "leaky_relu":
        slope = 0.0 if param == 0.0 else float(param or 0.01)
        return math.sqrt(2.0 / (1 + slope ** 2))
    if nonlinearity in recommended:
        return recommended[nonlinearity]
    raise ValueError(f"Unsupported nonlinearity: {nonlinearity}")


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def get_global_initializer():
    return _global_weight_init, _global_bias_init


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
