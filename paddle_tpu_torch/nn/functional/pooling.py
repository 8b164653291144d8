"""Pooling functionals (counterpart of
``paddle_tpu/nn/functional/pooling.py``): max and average pools 1-3D
and the adaptive pools, over ``torch.nn.functional``'s pools.

The windows are the JAX package's ``lax.reduce_window`` ones, not
PyTorch's: the input is padded explicitly (``-inf`` for max, 0 for
average) to any width, ``ceil_mode`` widens the high pad until the last
partial window is whole, and the padded input is pooled with no
padding.  An average divides by ``prod(k)``, except with
``exclusive=True`` and explicit padding, where it divides by the count
of input elements in the window; a string padding (``'SAME'`` /
``'VALID'``) always divides by ``prod(k)``, as in the JAX package.
``return_mask`` is accepted and no mask is returned, as in the JAX
package.  The adaptive pools' bins (``floor(j*n/m)`` to
``ceil((j+1)*n/m)``) are PyTorch's too.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d",
    "max_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d",
]

_MAX = {1: tF.max_pool1d, 2: tF.max_pool2d, 3: tF.max_pool3d}
_AVG = {1: tF.avg_pool1d, 2: tF.avg_pool2d, 3: tF.avg_pool3d}
_ADAPTIVE = {("max", 1): tF.adaptive_max_pool1d,
             ("max", 2): tF.adaptive_max_pool2d,
             ("max", 3): tF.adaptive_max_pool3d,
             ("avg", 1): tF.adaptive_avg_pool1d,
             ("avg", 2): tF.adaptive_avg_pool2d,
             ("avg", 3): tF.adaptive_avg_pool3d}


def _tuplize(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in (v if len(v) == n else v * n))[:n]
    return tuple(int(v) for _ in range(n))


def _pads(padding, n):
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (list, tuple)):
        flat = []
        for p in padding:
            if isinstance(p, (list, tuple)):
                flat.extend(int(x) for x in p)
            else:
                flat.append(int(p))
        if len(flat) == n:
            return [(p, p) for p in flat]
        return [(flat[2 * i], flat[2 * i + 1]) for i in range(n)]
    return [(int(padding), int(padding))] * n


def _window_pads(sizes, k, s, padding, ceil_mode):
    """The (low, high) pad of each spatial dim as ``lax.reduce_window``
    pads it."""
    if padding == "VALID":
        return [(0, 0)] * len(k)
    if padding == "SAME":
        pads = []
        for size, ki, si in zip(sizes, k, s):
            total = max((-(-size // si) - 1) * si + ki - size, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    pads = [list(p) for p in padding]
    if ceil_mode:
        for i, size in enumerate(sizes):
            rem = (size + pads[i][0] + pads[i][1] - k[i]) % s[i]
            if rem:
                pads[i][1] += s[i] - rem
    return [tuple(p) for p in pads]


def _flat(pads):
    out = []
    for lo, hi in reversed(pads):
        out.extend((lo, hi))
    return out


def _pool(x, kernel, stride, padding, n, data_format, reducer,
          ceil_mode=False, count_include_pad=True, divisor_override=None):
    channel_last = not data_format.startswith("NC")
    k = _tuplize(kernel, n)
    s = _tuplize(stride if stride is not None else kernel, n)
    p = _pads(padding, n)
    a = x.movedim(-1, 1) if channel_last else x
    pads = _window_pads(a.shape[2:], k, s, p, ceil_mode)
    padded = any(q != (0, 0) for q in pads)
    if reducer == "max":
        fill = -math.inf if a.is_floating_point() \
            else torch.iinfo(a.dtype).min
        ap = tF.pad(a, _flat(pads), value=fill) if padded else a
        out = _MAX[n](ap, k, s)
    else:
        ap = tF.pad(a, _flat(pads)) if padded else a
        if divisor_override:
            out = _AVG[n](ap, k, s) * (math.prod(k) / divisor_override)
        elif count_include_pad or isinstance(p, str) or not padded:
            out = _AVG[n](ap, k, s)
        else:
            ones = tF.pad(torch.ones((1, 1) + tuple(a.shape[2:]),
                                     dtype=a.dtype, device=a.device),
                          _flat(pads))
            out = _AVG[n](ap, k, s) / _AVG[n](ones, k, s)
        out = out.to(a.dtype)
    return out.movedim(1, -1) if channel_last else out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    fmt = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _pool(x, kernel_size, stride, padding, 1, fmt, "max",
                 ceil_mode=ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _pool(x, kernel_size, stride, padding, 2, data_format, "max",
                 ceil_mode=ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _pool(x, kernel_size, stride, padding, 3, data_format, "max",
                 ceil_mode=ceil_mode)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    fmt = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _pool(x, kernel_size, stride, padding, 1, fmt, "avg",
                 ceil_mode=ceil_mode, count_include_pad=not exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, data_format, "avg",
                 ceil_mode=ceil_mode, count_include_pad=not exclusive,
                 divisor_override=divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, data_format, "avg",
                 ceil_mode=ceil_mode, count_include_pad=not exclusive,
                 divisor_override=divisor_override)


def _adaptive(x, output_size, n, data_format, reducer):
    channel_last = not data_format.startswith("NC")
    sizes = output_size if isinstance(output_size, (list, tuple)) \
        else (output_size,) * n
    a = x.movedim(-1, 1) if channel_last else x
    target = tuple(int(o) if o is not None else s
                   for o, s in zip(sizes, a.shape[2:]))
    out = _ADAPTIVE[(reducer, n)](a, target)
    return out.movedim(1, -1) if channel_last else out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "NCW", "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, data_format, "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, data_format, "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, "NCW", "max")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, "NCHW", "max")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, "NCDHW", "max")
