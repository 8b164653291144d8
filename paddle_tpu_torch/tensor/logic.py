"""Comparison, logical and bitwise ops (counterpart of
``paddle_tpu/tensor/logic.py``)."""
from __future__ import annotations

import torch

from ..autograd import apply
from ._util import operands as _operands, tensor as _t

__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "logical_and", "logical_or",
           "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor",
           "logical_not", "bitwise_not", "equal_all", "allclose", "isclose",
           "is_empty", "is_tensor"]


def _cmp(fname, tfn):
    def op(x, y, name=None):
        return apply(tfn, *_operands(x, y), name=fname)
    op.__name__ = op.__qualname__ = fname
    return op


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)
logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)
bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)


def logical_not(x, name=None):
    return apply(torch.logical_not, _t(x), name="logical_not")


def bitwise_not(x, name=None):
    return apply(torch.bitwise_not, _t(x), name="bitwise_not")


def equal_all(x, y, name=None):
    """A bool scalar tensor: same shape and every element equal."""
    x, y = _operands(x, y)
    if tuple(x.shape) != tuple(y.shape):
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return (x == y).all()


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _operands(x, y)
    return torch.isclose(x, y.to(x.dtype), rtol=float(rtol),
                         atol=float(atol), equal_nan=equal_nan).all()


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply(lambda a, b: torch.isclose(a, b.to(a.dtype), rtol=float(rtol),
                                            atol=float(atol),
                                            equal_nan=equal_nan),
                 *_operands(x, y), name="isclose")


def is_empty(x, name=None):
    x = _t(x)
    return torch.full((), x.numel() == 0, dtype=torch.bool, device=x.device)


def is_tensor(x):
    return torch.is_tensor(x)
