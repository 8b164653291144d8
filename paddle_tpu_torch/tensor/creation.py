"""Tensor creation ops (counterpart of ``paddle_tpu/tensor/creation.py``).

A new tensor lands on the current device (the card unless
``set_device("cpu")`` was called) or on ``device`` when it is given; ops
on a tensor keep its device.  Float tensors take the default float dtype
unless a dtype is named.
"""
from __future__ import annotations

import numpy as np
import torch

from ..autograd import apply
from ..core.dtype import convert_dtype, default_float_dtype
from ..core.tensor import to_tensor  # noqa: F401  (re-export)
from ..device import current_device, resolve_device
from ._util import ints as _ints, tensor as _t

__all__ = ["zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
           "empty", "empty_like", "arange", "linspace", "logspace", "eye",
           "meshgrid", "diag", "diagflat", "diag_embed", "tril", "triu",
           "assign", "clone", "numel", "tril_indices", "triu_indices",
           "complex", "to_tensor"]


def _dev(device):
    return current_device() if device is None else resolve_device(device)


def _dt(dtype, default=None):
    d = convert_dtype(dtype)
    if d is None:
        d = default if default is not None else default_float_dtype()
    return d


def _v(x):
    return x.item() if torch.is_tensor(x) else x


def zeros(shape, dtype=None, name=None, *, device=None):
    return torch.zeros(_ints(shape), dtype=_dt(dtype), device=_dev(device))


def ones(shape, dtype=None, name=None, *, device=None):
    return torch.ones(_ints(shape), dtype=_dt(dtype), device=_dev(device))


def full(shape, fill_value, dtype=None, name=None, *, device=None):
    return torch.full(_ints(shape), _v(fill_value), dtype=_dt(dtype),
                      device=_dev(device))


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(_t(x), dtype=convert_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(_t(x), dtype=convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(_t(x), _v(fill_value), dtype=convert_dtype(dtype))


def empty(shape, dtype=None, name=None, *, device=None):
    """Zeros, as in the JAX package (no uninitialized memory)."""
    return zeros(shape, dtype, device=device)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None, *, device=None):
    """int64 when start, end and step are all integers, else the
    default float dtype."""
    start, end, step = _v(start), _v(end), _v(step)
    if end is None:
        start, end = 0, start
    d = convert_dtype(dtype)
    if d is None:
        d = torch.int64 if all(isinstance(v, (int, np.integer))
                               for v in (start, end, step)) \
            else default_float_dtype()
    return torch.arange(start, end, step, dtype=d, device=_dev(device))


def linspace(start, stop, num, dtype=None, name=None, *, device=None):
    return torch.linspace(_v(start), _v(stop), int(_v(num)),
                          dtype=_dt(dtype), device=_dev(device))


def logspace(start, stop, num, base=10.0, dtype=None, name=None, *,
             device=None):
    return torch.logspace(_v(start), _v(stop), int(_v(num)),
                          base=float(_v(base)), dtype=_dt(dtype),
                          device=_dev(device))


def eye(num_rows, num_columns=None, dtype=None, name=None, *, device=None):
    return torch.eye(int(num_rows),
                     int(num_rows if num_columns is None else num_columns),
                     dtype=_dt(dtype), device=_dev(device))


def meshgrid(*args, **kwargs):
    """``ij`` indexing; a single list argument holds the vectors."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(torch.meshgrid(*[_t(a) for a in args], indexing="ij"))


def diag(x, offset=0, padding_value=0, name=None):
    """A vector becomes a matrix with it on diagonal ``offset`` (the rest
    ``padding_value``); a matrix gives its diagonal ``offset``."""
    def _diag(a):
        if a.dim() == 1:
            out = torch.diag(a, offset)
            if padding_value != 0:
                keep = torch.diag(torch.ones_like(a, dtype=torch.bool),
                                  offset)
                out = torch.where(keep, out,
                                  torch.full_like(out, padding_value))
            return out
        return torch.diagonal(a, offset)

    return apply(_diag, _t(x), name="diag")


def diagflat(x, offset=0, name=None):
    return apply(lambda a: torch.diagflat(a, offset), _t(x), name="diagflat")


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return apply(lambda a: torch.diag_embed(a, offset, dim1, dim2), _t(x),
                 name="diag_embed")


def tril(x, diagonal=0, name=None):
    return apply(lambda a: torch.tril(a, diagonal), _t(x), name="tril")


def triu(x, diagonal=0, name=None):
    return apply(lambda a: torch.triu(a, diagonal), _t(x), name="triu")


def assign(x, output=None):
    """A copy of ``x``; with ``output``, ``output`` takes ``x``'s value
    (and shape) in place and is returned."""
    src = _t(x) if output is None else (
        x if torch.is_tensor(x) else to_tensor(x, place=output.device))
    if output is not None:
        with torch.no_grad():
            if output.shape == src.shape:
                output.copy_(src)
            else:
                output.data = src.detach().to(output.dtype).clone()
        return output
    return src.clone()


def clone(x, name=None):
    return x.clone()


def numel(x, name=None):
    return torch.full((), x.numel(), dtype=torch.int64, device=x.device)


def tril_indices(row, col, offset=0, dtype="int64", *, device=None):
    return torch.tril_indices(int(row), int(col), int(offset),
                              dtype=convert_dtype(dtype), device=_dev(device))


def triu_indices(row, col=None, offset=0, dtype="int64", *, device=None):
    col = row if col is None else col
    return torch.triu_indices(int(row), int(col), int(offset),
                              dtype=convert_dtype(dtype), device=_dev(device))


def complex(real, imag, name=None):
    return apply(torch.complex, _t(real), _t(imag), name="complex")
