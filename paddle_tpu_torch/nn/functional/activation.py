"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``).

Each takes Paddle's arguments and the JAX package's formulas; each casts
its inputs by its op name under ``amp.auto_cast``.  The in-place forms
(``relu_``, ``elu_``, ``softmax_``, ``tanh_``) write into their input.
``rrelu`` uses the mean slope ``(lower + upper) / 2`` in training too,
as the JAX package does.
"""
from __future__ import annotations

import torch
from torch.nn import functional as TF

from ...amp.auto_cast import cast_inputs
from ...core.dtype import convert_dtype

__all__ = [
    "relu", "relu6", "relu_", "elu", "elu_", "selu", "celu", "gelu", "sigmoid",
    "hardsigmoid", "hardswish", "hardtanh", "hardshrink", "softshrink",
    "tanhshrink", "leaky_relu", "log_sigmoid", "log_softmax", "softmax",
    "softmax_", "softplus", "softsign", "swish", "silu", "mish", "tanh",
    "tanh_", "thresholded_relu", "maxout", "prelu", "glu", "rrelu",
    "gumbel_softmax",
]


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def relu(x, name=None):
    (x,) = cast_inputs("relu", x)
    return torch.relu(x)


def relu_(x, name=None):
    return torch.relu_(x)


def relu6(x, name=None):
    (x,) = cast_inputs("relu6", x)
    return torch.clamp(x, 0.0, 6.0)


def elu(x, alpha=1.0, name=None):
    (x,) = cast_inputs("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def elu_(x, alpha=1.0, name=None):
    return TF.elu_(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    (x,) = cast_inputs("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    (x,) = cast_inputs("celu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def gelu(x, approximate=False, name=None):
    """GELU; ``approximate=True`` is the tanh form GPT's MLP uses."""
    (x,) = cast_inputs("gelu", x)
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def sigmoid(x, name=None):
    (x,) = cast_inputs("sigmoid", x)
    return torch.sigmoid(x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    (x,) = cast_inputs("hardsigmoid", x)
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    (x,) = cast_inputs("hardswish", x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0, name=None):
    (x,) = cast_inputs("hardtanh", x)
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    (x,) = cast_inputs("hardshrink", x)
    return torch.where(x.abs() > threshold, x, _zero(x))


def softshrink(x, threshold=0.5, name=None):
    (x,) = cast_inputs("softshrink", x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, _zero(x)))


def tanhshrink(x, name=None):
    (x,) = cast_inputs("tanhshrink", x)
    return x - torch.tanh(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    (x,) = cast_inputs("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


def log_sigmoid(x, name=None):
    (x,) = cast_inputs("log_sigmoid", x)
    return TF.logsigmoid(x)


def log_softmax(x, axis=-1, dtype=None, name=None):
    (x,) = cast_inputs("log_softmax", x)
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def softmax(x, axis=-1, dtype=None, name=None):
    (x,) = cast_inputs("softmax", x)
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.softmax(x, dim=axis)


def softmax_(x, axis=-1, dtype=None, name=None):
    return x.copy_(softmax(x, axis, dtype))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    (x,) = cast_inputs("softplus", x)
    return torch.where(beta * x > threshold, x,
                       torch.logaddexp(beta * x, _zero(x)) / beta)


def softsign(x, name=None):
    (x,) = cast_inputs("softsign", x)
    return x / (1 + x.abs())


def swish(x, name=None):
    (x,) = cast_inputs("swish", x)
    return TF.silu(x)


silu = swish


def mish(x, name=None):
    (x,) = cast_inputs("mish", x)
    return x * torch.tanh(TF.softplus(x))


def tanh(x, name=None):
    (x,) = cast_inputs("tanh", x)
    return torch.tanh(x)


def tanh_(x, name=None):
    return torch.tanh_(x)


def thresholded_relu(x, threshold=1.0, name=None):
    (x,) = cast_inputs("thresholded_relu", x)
    return torch.where(x > threshold, x, _zero(x))


def maxout(x, groups, axis=1, name=None):
    (x,) = cast_inputs("maxout", x)
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(dim=ax + 1)


def prelu(x, weight, data_format="NCHW", name=None):
    x, weight = cast_inputs("prelu", x, weight)
    if weight.numel() == 1:
        wb = weight.reshape(())
    else:
        shape = [1] * x.dim()
        shape[1 if data_format.startswith("NC") else x.dim() - 1] = \
            weight.numel()
        wb = weight.reshape(shape)
    return torch.where(x >= 0, x, wb * x)


def glu(x, axis=-1, name=None):
    (x,) = cast_inputs("glu", x)
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None):
    (x,) = cast_inputs("rrelu", x)
    return torch.where(x >= 0, x, (lower + upper) / 2.0 * x)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Softmax of ``(x + Gumbel noise) / temperature``; ``hard`` gives the
    straight-through one-hot (forward one-hot, backward soft)."""
    (x,) = cast_inputs("gumbel_softmax", x)
    u = torch.empty_like(x).uniform_(1e-20, 1.0)
    g = -torch.log(-torch.log(u + 1e-20))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = y + (y_hard - y).detach()
    return y
