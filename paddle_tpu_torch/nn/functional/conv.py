"""Convolution functionals (counterpart of
``paddle_tpu/nn/functional/conv.py``): ``conv1d/2d/3d`` and their
transposes over ``torch.nn.functional.conv*`` (cuDNN on the card).

Weights keep Paddle's layout, which is PyTorch's: ``[O, I/g, *k]`` and
``[I, O/g, *k]`` for the transposes.  Padding follows the JAX package's
``lax.conv_general_dilated`` rules, not PyTorch's: an int, ``n`` ints,
``2n`` ints (low / high pairs), ``'SAME'`` (lax's rule, asymmetric when
the total is odd, any stride) or ``'VALID'``.  Asymmetric pads are made
by ``F.pad`` before a convolution with no padding.  A transposed
convolution runs at padding 0 and is then cropped (or zero-extended)
to the JAX package's pads ``(k-1-p_lo, k-1-p_hi+output_padding)`` and
to ``output_size``.  Channel-last formats permute to channel-first and
back.  Each function casts its inputs by its op name under
``amp.auto_cast`` (the convolutions are on the bf16 list).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...amp.auto_cast import cast_inputs
from .common import _promoted

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}
_CONV_T = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d,
           3: tF.conv_transpose3d}


def _tuplize(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        return tuple(int(x) for x in v)
    return tuple(int(v) for _ in range(n))


def _padding_arg(padding, n):
    """Paddle padding: an int, ``n`` ints, ``2n`` ints (pairs), 'SAME',
    'VALID' -> the string or ``n`` (low, high) pairs."""
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
        if len(flat) == 2 * n:
            return [(flat[2 * i], flat[2 * i + 1]) for i in range(n)]
        raise ValueError(f"bad padding {padding}")
    return [(int(padding), int(padding))] * n


def _same_pads(sizes, kernel, stride, dilation):
    """lax's 'SAME': ``ceil(in / s)`` outputs, the total pad split with
    the odd element high."""
    pads = []
    for size, k, s, d in zip(sizes, kernel, stride, dilation):
        eff = (k - 1) * d + 1
        out = -(-size // s)
        total = max((out - 1) * s + eff - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_arg(pads):
    """(low, high) pairs of the spatial dims -> ``F.pad``'s last-dim-first
    list (a negative entry crops)."""
    out = []
    for lo, hi in reversed(pads):
        out.extend((lo, hi))
    return out


def _channel_first(x, channel_last):
    return x.movedim(-1, 1) if channel_last else x


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          data_format, name):
    channel_last = not data_format.startswith("NC")
    x, weight, bias = _promoted(*cast_inputs(name, x, weight, bias))
    st = _tuplize(stride, n)
    dl = _tuplize(dilation, n)
    pad = _padding_arg(padding, n)
    a = _channel_first(x, channel_last)
    if pad == "SAME":
        pad = _same_pads(a.shape[2:], weight.shape[2:], st, dl)
    elif pad == "VALID":
        pad = [(0, 0)] * n
    if all(lo == hi and lo >= 0 for lo, hi in pad):
        out = _CONV[n](a, weight, bias, st, tuple(lo for lo, _ in pad), dl,
                       groups)
    else:
        out = _CONV[n](tF.pad(a, _pad_arg(pad)), weight, bias, st, 0, dl,
                       groups)
    return out.movedim(1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    fmt = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 fmt, "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format, "conv3d")


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, data_format, output_size, name):
    channel_last = not data_format.startswith("NC")
    x, weight, bias = _promoted(*cast_inputs(name, x, weight, bias))
    st = _tuplize(stride, n)
    dl = _tuplize(dilation, n)
    opad = _tuplize(output_padding, n) if output_padding is not None \
        else (0,) * n
    pad = _padding_arg(padding, n)
    if pad == "SAME":
        pad = []
        for i in range(n):
            total = max((weight.shape[2 + i] - 1) * dl[i] + 1 - st[i], 0)
            pad.append((total // 2, total - total // 2))
    elif pad == "VALID":
        pad = [(0, 0)] * n
    a = _channel_first(x, channel_last)
    # the whole transposed output ((in-1)*s + k_eff per dim), then the
    # JAX pads: p_lo cropped low, p_hi - output_padding cropped high (a
    # negative amount appends positions no input reaches: zeros)
    out = _CONV_T[n](a, weight, None, st, 0, 0, groups, dl)
    crop = [(-lo, opad[i] - hi) for i, (lo, hi) in enumerate(pad)]
    if any(c != (0, 0) for c in crop):
        out = tF.pad(out, _pad_arg(crop))
    if output_size is not None:
        target = _tuplize(output_size, n)
        out = out[(slice(None), slice(None)) +
                  tuple(slice(0, t) for t in target)]
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return out.movedim(1, -1) if channel_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    fmt = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, fmt, output_size,
                           "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format, output_size,
                           "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format, output_size,
                           "conv3d_transpose")
