"""Search, sort and selection (counterpart of
``paddle_tpu/tensor/search.py``).

Tie order follows the JAX package: a descending ``sort`` / ``argsort``
without ``stable`` is the flip of a stable ascending sort, so tied
elements come out in reverse index order; ``stable=True`` keeps index
order.  ``topk`` returns the lower index first among ties (as
``jax.lax.top_k``), ``kthvalue`` takes the stable ascending order, and
``mode`` returns the smallest of the most frequent values with the last
index holding it.  ``nonzero``, ``where(cond)`` and ``masked_select``
have data-dependent shapes: on the card they read a size back to the
host.
"""
from __future__ import annotations

import torch

from ..autograd import apply
from ..core.dtype import convert_dtype
from ._util import tensor as _t
from .manipulation import (index_sample, index_select,  # noqa: F401
                           masked_select)

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "kthvalue",
           "mode", "where", "nonzero", "masked_select", "searchsorted",
           "index_select", "index_sample", "bucketize"]


def _arg(fn, x, axis, keepdim, dtype, name):
    d = convert_dtype(dtype)

    def _a(a):
        if axis is None:
            out = fn(a.reshape(-1), 0)
            return out.reshape([1] * a.dim()).to(d) if keepdim else out.to(d)
        return fn(a, axis, keepdim=keepdim).to(d)

    return apply(_a, _t(x), name=name)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    """The first index of the maximum."""
    return _arg(torch.argmax, x, axis, keepdim, dtype, "argmax")


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype, "argmin")


def _order(a, axis, descending, stable):
    """int64 sort indices of ``a`` along ``axis`` by the JAX rule."""
    if descending and stable:
        return torch.sort(a, dim=axis, descending=True, stable=True).indices
    idx = torch.sort(a, dim=axis, stable=True).indices
    return torch.flip(idx, (axis,)) if descending else idx


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return apply(lambda a: _order(a, axis, descending, stable), _t(x),
                 name="argsort")


def sort(x, axis=-1, descending=False, stable=False, name=None):
    """Sorted values; the gradient follows the index order of
    ``argsort``."""
    return apply(lambda a: torch.take_along_dim(
        a, _order(a, axis, descending, stable), axis), _t(x), name="sort")


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    kk = int(k.item()) if torch.is_tensor(k) else int(k)

    def _topk(a):
        ax = a.dim() - 1 if axis is None else axis % a.dim()
        idx = torch.sort(a, dim=ax, descending=largest,
                         stable=True).indices.narrow(ax, 0, kk)
        return torch.take_along_dim(a, idx, ax), idx

    return apply(_topk, _t(x), name="top_k")


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def _kth(a):
        ax = axis % a.dim()
        idx = torch.sort(a, dim=ax, stable=True).indices.narrow(ax, k - 1, 1)
        v = torch.take_along_dim(a, idx, ax)
        if not keepdim:
            v, idx = v.squeeze(ax), idx.squeeze(ax)
        return v, idx
    return apply(_kth, _t(x), name="kthvalue")


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest one on a tie
    of counts) and the last index holding it; computed on the device from
    one sort."""
    x = _t(x)
    ax = axis % x.dim()
    a = torch.movedim(x, ax, -1)
    srt = torch.sort(a, dim=-1).values
    new = torch.ones_like(srt, dtype=torch.bool)
    new[..., 1:] = srt[..., 1:] != srt[..., :-1]
    run = torch.cumsum(new.long(), -1) - 1
    counts = torch.zeros_like(run).scatter_add_(-1, run, torch.ones_like(run))
    best = torch.argmax(counts, -1, keepdim=True)  # first max: smallest value
    start = torch.argmax((run == best).long(), -1, keepdim=True)
    vals = srt.gather(-1, start)
    pos = torch.arange(a.shape[-1], device=a.device)
    idx = torch.where(a == vals, pos, -1).amax(-1, keepdim=True)
    vals, idx = torch.movedim(vals, -1, ax), torch.movedim(idx, -1, ax)
    if not keepdim:
        vals, idx = vals.squeeze(ax), idx.squeeze(ax)
    return vals, idx


def where(condition, x=None, y=None, name=None):
    """``condition ? x : y``; with neither, ``nonzero(condition,
    as_tuple=True)``."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    x, y = (v if isinstance(v, (bool, int, float)) else _t(v) for v in (x, y))
    return apply(lambda cc, a, b: torch.where(cc.bool(), a, b),
                 _t(condition), x, y, name="where")


def nonzero(x, as_tuple=False):
    """int64 indices of the non-zero elements: ``[n, ndim]``, or one
    vector a dim."""
    x = _t(x)
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    s, v = _t(sorted_sequence), _t(values)
    return apply(lambda a, b: torch.searchsorted(a, b.to(a.dtype),
                                                 out_int32=out_int32,
                                                 right=right),
                 s, v, name="searchsorted")


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)
