"""Argument handling shared by the op library's modules."""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import to_tensor


def tensor(x):
    """``x`` as a tensor: host data goes to the current device."""
    return x if torch.is_tensor(x) else to_tensor(x)


def operands(x, y):
    """Both operands of a binary op as tensors: a Python scalar becomes a
    0-dim CPU tensor, which promotes like a scalar (bf16 + 2.5 stays
    bf16, int32 + 2.5 is f32) and which torch's ops take beside a CUDA
    tensor with no copy to the card; other host data goes to the other
    operand's device."""
    if torch.is_tensor(x) and torch.is_tensor(y):
        return x, y
    if torch.is_tensor(x):
        return x, _scalar_or(y, x.device)
    if torch.is_tensor(y):
        return _scalar_or(x, y.device), y
    return tensor(x), tensor(y)


def _scalar_or(v, device):
    t = torch.as_tensor(v)
    return t if t.dim() == 0 else t.to(device)


def ints(seq):
    """A shape, axis list or index list as a tuple of ints."""
    if torch.is_tensor(seq):
        return tuple(int(v) for v in seq.reshape(-1).tolist())
    if isinstance(seq, (int, np.integer)):
        return (int(seq),)
    return tuple(int(v.item()) if torch.is_tensor(v) else int(v)
                 for v in seq)


def axis_arg(axis):
    """None, an int, or a tuple of ints (from a list or a tensor)."""
    if axis is None:
        return None
    if torch.is_tensor(axis) or isinstance(axis, (list, tuple)):
        return ints(axis)
    return int(axis)


def dims(axis, ndim):
    """The reduced dims of ``axis`` (None: all of them) as a tuple."""
    if axis is None:
        return tuple(range(ndim))
    return tuple(a % max(ndim, 1) for a in
                 (axis if isinstance(axis, tuple) else (axis,)))
