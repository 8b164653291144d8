"""The op library as ``torch.Tensor`` methods (counterpart of
``paddle_tpu/tensor/tensor_methods.py``).

Importing the port binds each op that takes a tensor first under its
Paddle name, ``x.scatter_nd_add(...)`` or ``x.astype("float16")``, but
only where ``torch.Tensor`` has no attribute of that name: a torch
method or operator is never replaced (``x.sum``, ``x.max``, ``x + y``
keep torch's meaning).  ``BOUND`` lists the names bound.
"""
from __future__ import annotations

import torch

from . import (attribute, creation, linalg, logic, manipulation, math,
               random, search)

_METHOD_SOURCES = [math, manipulation, logic, search, linalg, attribute,
                   creation, random]

# ops whose first argument is not the tensor the method would bind to
_SKIP = {
    "to_tensor", "zeros", "ones", "full", "arange", "linspace", "logspace",
    "eye", "empty", "meshgrid", "tril_indices", "triu_indices", "assign",
    "rand", "randn", "randint", "randperm", "uniform", "normal", "gaussian",
    "standard_normal", "shape", "scatter_nd", "broadcast_shape", "complex",
    "binomial", "einsum",
}

BOUND = []


def _bind():
    for mod in _METHOD_SOURCES:
        for name in mod.__all__:
            fn = getattr(mod, name)
            if name in _SKIP or not callable(fn) or isinstance(fn, type):
                continue
            if not hasattr(torch.Tensor, name):
                setattr(torch.Tensor, name, fn)
                BOUND.append(name)
    if not hasattr(torch.Tensor, "astype"):
        torch.Tensor.astype = manipulation.cast
        BOUND.append("astype")


_bind()
