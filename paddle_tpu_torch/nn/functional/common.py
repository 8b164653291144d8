"""Common functionals (counterpart of
``paddle_tpu/nn/functional/common.py``): linear, the dropouts, embedding,
one_hot, pad, unfold / fold, interpolate, cosine_similarity, the pixel
shuffles, label_smooth, bilinear, channel_shuffle.

``linear`` takes Paddle's weight layout ``[in, out]`` (``x @ W + b``).
Each function casts its inputs by its op name under ``amp.auto_cast``.
``interpolate`` samples as the JAX package's ``jax.image.resize`` does:
half-pixel centres, nearest by ``floor((i + 0.5) * in / out)``, linear
and Keys cubic (a = -0.5) weights, widened by the scale when
downsampling (antialiasing); ``align_corners`` linear modes use the
``x_in = x_out * (in - 1) / (out - 1)`` grid.  Dropout draws from the
device's default generator (``seed`` reseeds it).
"""
from __future__ import annotations

import numpy as np
import torch

from ...amp.auto_cast import cast_inputs
from ...core.selected_rows import embedding_sparse, gather_rows

__all__ = [
    "linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "embedding", "one_hot", "pad", "zeropad2d", "unfold", "fold",
    "interpolate", "upsample", "cosine_similarity", "pixel_shuffle",
    "pixel_unshuffle", "label_smooth", "bilinear", "channel_shuffle",
]


def _pair(v, n=2):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def _promoted(*ts):
    """The tensors in their common dtype (bf16 with f32 is f32), as the
    JAX package's products promote mixed operands."""
    dt = ts[0].dtype
    for t in ts[1:]:
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    return tuple(t if t is None or t.dtype == dt else t.to(dt) for t in ts)


def linear(x, weight, bias=None, name=None):
    """``x @ W + b`` with W ``[in_features, out_features]``."""
    x, weight, bias = _promoted(*cast_inputs("linear", x, weight, bias))
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Inverted dropout (``upscale_in_train``) or ``downscale_in_infer``;
    ``axis`` draws one bit per index of those axes (broadcast over the
    others)."""
    (x,) = cast_inputs("dropout", x)
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if axis is None and mode == "upscale_in_train":
        return torch.nn.functional.dropout(x, p, training=True)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = torch.rand(shape, device=x.device) >= p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    (x,) = cast_inputs("alpha_dropout", x)
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = torch.rand(x.shape, device=x.device) >= p
    q = 1.0 - p
    a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
    b_coef = -a_coef * alpha_p * p
    dropped = torch.where(keep, x, torch.full_like(x, alpha_p))
    return (a_coef * dropped + b_coef).to(x.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` by ``x`` (-1 reads the last row); rows at
    ``padding_idx`` come out zero (and pass no gradient).  With
    ``sparse=True`` the eager weight gradient is row-sparse (a sparse COO
    ``.grad``, ``core.selected_rows``); inside the trainer's step the
    lookup is the plain gather either way."""
    (x, weight) = cast_inputs("embedding", x, weight)
    if sparse:
        return embedding_sparse(x, weight, padding_idx)
    return gather_rows(x.long(), weight, padding_idx)


def one_hot(x, num_classes, name=None):
    """f32 one-hot rows (the JAX package's ``jax.nn.one_hot``); labels
    out of range give zero rows."""
    (x,) = cast_inputs("one_hot", x)
    x = x.long()
    ok = (x >= 0) & (x < num_classes)
    out = torch.nn.functional.one_hot(torch.where(ok, x, 0), num_classes)
    return (out * ok[..., None]).to(torch.float32)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``pad``: 2 * ndim widths in dim order, or 2 * k widths of the
    spatial dims of ``data_format``, innermost dim first (Paddle's
    convention)."""
    (x,) = cast_inputs("pad", x)
    p = [int(v) for v in (pad.tolist() if torch.is_tensor(pad) else pad)]
    nd = x.dim()
    if len(p) == 2 * nd:
        widths = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
    else:
        k = len(p) // 2
        widths = [(0, 0)] * nd
        if data_format.endswith("C") and data_format.startswith("N"):
            spatial = list(range(1, 1 + k))
        else:
            spatial = list(range(nd - k, nd))
        for i, ax in enumerate(reversed(spatial)):
            widths[ax] = (p[2 * i], p[2 * i + 1])
    # torch lists pads last dim first, (before, after) each
    flat = [w for pair in reversed(widths) for w in pair]
    if mode == "constant":
        return torch.nn.functional.pad(x, flat, mode="constant", value=value)
    tmode = {"reflect": "reflect", "replicate": "replicate",
             "circular": "circular"}[mode]
    # torch pads up to three trailing dims of a [N, C, ...] input here:
    # fold the dims before the first padded one into N
    lead = next((i for i, w in enumerate(widths) if w != (0, 0)), nd)
    if lead == nd:
        return x
    if lead < nd - 3:
        raise NotImplementedError(
            f"pad(mode={mode!r}) of more than the last three dims")
    shape = tuple(x.shape)
    flat = [w for pair in reversed(widths[lead:]) for w in pair]
    y = torch.nn.functional.pad(x.reshape((-1, 1) + shape[lead:]), flat,
                                mode=tmode)
    return y.reshape(shape[:lead] + tuple(y.shape[2:]))


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C * kh * kw, L]``; ``paddings`` of 4 are (top,
    bottom, left, right)."""
    (x,) = cast_inputs("unfold", x)
    ks, st, dl = _pair(kernel_sizes), _pair(strides), _pair(dilations)
    pd = _pair(paddings, 4)
    if len(pd) == 2:
        pd = (pd[0], pd[0], pd[1], pd[1])
    x = torch.nn.functional.pad(x, (pd[2], pd[3], pd[0], pd[1]))
    return torch.nn.functional.unfold(x, ks, dilation=dl, stride=st)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the inverse of ``unfold`` (overlaps summed)."""
    (x,) = cast_inputs("fold", x)
    return torch.nn.functional.fold(
        x, _pair(output_sizes), _pair(kernel_sizes),
        dilation=_pair(dilations), padding=_pair(paddings),
        stride=_pair(strides))


def _linear_kernel(x):
    return torch.clamp(1.0 - x, min=0.0)


def _cubic_kernel(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(in_size, out_size, kernel, device):
    """``[in, out]`` sampling weights of ``jax.image.resize`` along one
    axis (half-pixel centres, antialiased downsampling)."""
    scale = out_size / in_size
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - src[:, None]).abs() / kscale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _align_corners_axis(a, axis, out_size):
    in_size = a.shape[axis]
    if out_size == in_size:
        return a
    if out_size == 1 or in_size == 1:
        idx = torch.zeros(out_size, dtype=torch.long, device=a.device)
        return a.index_select(axis, idx)
    coords = torch.arange(out_size, dtype=torch.float32, device=a.device) \
        * ((in_size - 1) / (out_size - 1))
    lo = coords.floor().long()
    hi = (lo + 1).clamp(max=in_size - 1)
    shape = [1] * a.dim()
    shape[axis] = out_size
    w = (coords - lo.float()).reshape(shape)
    return a.index_select(axis, lo) * (1 - w) + a.index_select(axis, hi) * w


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dims (nearest, linear, bilinear, trilinear,
    bicubic, area) to ``size`` or ``in * scale_factor``."""
    (x,) = cast_inputs("interpolate", x)
    mode = mode.lower()
    if torch.is_tensor(size):
        size = [int(v) for v in size.tolist()]
    channel_last = not data_format.startswith("NC")
    axes = list(range(1, x.dim() - 1)) if channel_last \
        else list(range(2, x.dim()))
    spatial = [x.shape[a] for a in axes]
    if size is not None:
        out = [int(s) for s in (size if isinstance(size, (list, tuple))
                                else [size])]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * len(spatial)
        out = [int(s * f) for s, f in zip(spatial, sf)]
    if align_corners and mode in ("linear", "bilinear", "trilinear"):
        y = x.float()
        for ax, n in zip(axes, out):
            y = _align_corners_axis(y, ax, n)
        return y.to(x.dtype)
    if mode == "nearest":
        y = x
        for ax, m, n in zip(axes, spatial, out):
            if m != n:
                idx = np.floor((np.arange(n, dtype=np.float32) + 0.5) * m
                               / n).astype(np.int64)
                y = y.index_select(ax, torch.from_numpy(idx).to(x.device))
        return y
    kernel = _cubic_kernel if mode == "bicubic" else _linear_kernel
    y = x.float()
    for ax, m, n in zip(axes, spatial, out):
        if m == n:
            continue
        w = _resize_weights(m, n, kernel, x.device)
        y = torch.movedim(torch.tensordot(y, w, dims=([ax], [0])), -1, ax)
    return y.to(x.dtype)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    x1, x2 = cast_inputs("cosine_similarity", x1, x2)
    dot = (x1 * x2).sum(axis)
    n1 = (x1 * x1).sum(axis).sqrt()
    n2 = (x2 * x2).sum(axis).sqrt()
    return dot / torch.clamp(n1 * n2, min=eps)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    (x,) = cast_inputs("pixel_shuffle", x)
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    (x,) = cast_inputs("pixel_unshuffle", x)
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // r, w // r, c * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    (x,) = cast_inputs("channel_shuffle", x)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
        return x.reshape(n, c, h, w)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, groups, c // groups).transpose(3, 4)
    return x.reshape(n, h, w, c)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - eps) * label + eps * prior`` (uniform prior ``1 / K``)."""
    label, prior_dist = cast_inputs("label_smooth", label, prior_dist)
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[n, o] = x1[n, i] W[o, i, j] x2[n, j] + b[o]``."""
    x1, x2, weight, bias = _promoted(
        *cast_inputs("bilinear", x1, x2, weight, bias))
    out = torch.einsum("ni,oij,nj->no", x1, weight, x2)
    return out if bias is None else out + bias

