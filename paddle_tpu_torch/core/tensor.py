"""Tensors and parameters (counterpart of ``paddle_tpu/core/tensor.py``).

A tensor of the port is a ``torch.Tensor``: there is no wrapper class.
``Parameter`` is a ``torch.nn.Parameter`` carrying Paddle's attributes:
``name``, ``trainable`` (tied to ``requires_grad``), ``stop_gradient``
(its negation), ``optimize_attr`` (the per-parameter learning-rate
scale the optimizers read), ``regularizer``, ``need_clip`` and
``is_distributed``.  They survive ``copy.deepcopy`` (the transformer
stacks copy their first layer) and pickling.
"""
from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ..device import current_device, resolve_device
from .dtype import convert_dtype, default_float_dtype

__all__ = ["Parameter", "to_tensor", "is_tensor", "from_numpy"]

_param_counter = 0


def _rebuild_parameter(data, requires_grad, attrs):
    p = Parameter(data, trainable=requires_grad)
    p.__dict__.update(attrs)
    return p


class Parameter(torch.nn.Parameter):
    """A trainable tensor with Paddle's parameter attributes."""

    def __new__(cls, data=None, name: Optional[str] = None,
                trainable: bool = True):
        if data is None:
            data = torch.empty(0)
        return super().__new__(cls, data, requires_grad=bool(trainable))

    def __init__(self, data=None, name: Optional[str] = None,
                 trainable: bool = True):
        global _param_counter
        if name is None:
            name = f"param_{_param_counter}"
            _param_counter += 1
        self.__dict__["_name"] = name
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.is_distributed = False

    # TensorBase.name is read-only: the parameter keeps its own
    @property
    def name(self) -> str:
        return self.__dict__.get("_name")

    @name.setter
    def name(self, value):
        self.__dict__["_name"] = value

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         trainable=self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out

    def __reduce_ex__(self, proto):
        return (_rebuild_parameter,
                (self.data, self.requires_grad, dict(self.__dict__)))

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


def from_numpy(arr) -> torch.Tensor:
    """A host array as a CPU tensor (a copy), ``ml_dtypes.bfloat16``
    arrays (the JAX package's numpy form of bf16) included."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.tensor(arr)


def to_tensor(data, dtype=None, place=None, stop_gradient=True
              ) -> torch.Tensor:
    """``paddle.to_tensor``: host data (lists, numbers, numpy arrays) or a
    tensor as a tensor on ``place`` (default: the current device).
    Float64 host data takes the default float dtype, as in the JAX
    package; ``stop_gradient=False`` makes a leaf that wants a
    gradient."""
    dev = current_device() if place is None else resolve_device(place)
    d = convert_dtype(dtype)
    if torch.is_tensor(data):
        t = data.detach().to(device=dev, dtype=d, copy=True)
    else:
        arr = np.asarray(data)
        if d is None and arr.dtype == np.float64:
            d = default_float_dtype()
        t = from_numpy(arr).to(device=dev, dtype=d)
    if not stop_gradient:
        t.requires_grad_(True)
    return t


def is_tensor(x) -> bool:
    return torch.is_tensor(x)
