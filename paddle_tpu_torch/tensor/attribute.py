"""Tensor attribute ops (counterpart of ``paddle_tpu/tensor/attribute.py``)."""
from __future__ import annotations

import math

import torch

from ..autograd import apply
from ._util import tensor as _t

__all__ = ["shape", "rank", "is_floating_point", "is_integer", "is_complex",
           "real", "imag", "conj", "angle", "set_printoptions"]


def shape(input):
    """``paddle.shape``: the shape as a 1-D int32 tensor on the input's
    device."""
    x = _t(input)
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


def rank(input):
    x = _t(input)
    return torch.full((), x.dim(), dtype=torch.int32, device=x.device)


def is_floating_point(x):
    return x.dtype.is_floating_point


def is_integer(x):
    return not (x.dtype.is_floating_point or x.dtype.is_complex
                or x.dtype == torch.bool)


def is_complex(x):
    return x.dtype.is_complex


def real(x, name=None):
    """The real part; a real tensor is its own real part."""
    return apply(lambda a: torch.real(a) if a.is_complex() else a, _t(x),
                 name="real")


def imag(x, name=None):
    return apply(lambda a: torch.imag(a) if a.is_complex()
                 else torch.zeros_like(a), _t(x), name="imag")


def conj(x, name=None):
    return apply(lambda a: torch.conj(a).resolve_conj() if a.is_complex()
                 else a, _t(x), name="conj")


def angle(x, name=None):
    """Of a real tensor: pi where it is negative, else 0."""
    def _angle(a):
        if a.is_complex() or a.is_floating_point():
            return torch.angle(a)
        return torch.where(a < 0, math.pi, 0.0)
    return apply(_angle, _t(x), name="angle")


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """How tensors print: the port's tensors print through torch, so this
    sets torch's print options."""
    kw = {}
    if precision is not None:
        kw["precision"] = int(precision)
    if threshold is not None:
        kw["threshold"] = int(threshold)
    if edgeitems is not None:
        kw["edgeitems"] = int(edgeitems)
    if linewidth is not None:
        kw["linewidth"] = int(linewidth)
    if sci_mode is not None:
        kw["sci_mode"] = bool(sci_mode)
    torch.set_printoptions(**kw)
