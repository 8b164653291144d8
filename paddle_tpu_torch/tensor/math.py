"""Elementwise, reduction and matrix math (counterpart of
``paddle_tpu/tensor/math.py``).

Every op is PyTorch on the input's device, and PyTorch's autograd
differentiates it.  Where a torch function's meaning differs from the
JAX package's, the JAX meaning wins: ``median`` and ``nanmedian`` average
the two middle values of an even count (``torch.median`` returns the
lower one), ``mean`` of an integer tensor is a float, reductions take a
tuple of axes, and ``cumsum`` / ``cumprod`` / ``logcumsumexp`` over
``axis=None`` run on the flattened tensor.
"""
from __future__ import annotations

import torch

from ..autograd import apply
from ..core.dtype import convert_dtype, default_float_dtype
from ._util import (axis_arg as _axis_arg, dims as _dims,
                    operands as _operands, tensor as _t)

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "floor_mod", "pow", "maximum", "minimum", "fmax", "fmin",
    "atan2", "heaviside", "hypot", "logaddexp", "nextafter", "copysign",
    "gcd", "lcm", "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "sqrt", "rsqrt", "square", "exp", "expm1", "log",
    "log2", "log10", "log1p", "abs", "ceil", "floor", "round", "trunc",
    "frac", "sign", "neg", "reciprocal", "sin", "cos", "tan", "asin", "acos",
    "atan", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "erf",
    "erfinv", "lgamma", "digamma", "i0", "i1", "deg2rad", "rad2deg", "isnan",
    "isinf", "isfinite", "logit", "sigmoid", "clip", "nan_to_num", "scale",
    "stanh", "multiplex", "sum", "mean", "max", "min", "amax", "amin",
    "prod", "logsumexp", "all", "any", "count_nonzero", "cumsum", "cumprod",
    "cummax", "cummin", "add_n", "diff", "trace", "lerp", "kron", "inner",
    "outer", "matmul", "mm", "bmm", "dot", "mv", "addmm", "std", "var",
    "median", "nanmedian", "nanmean", "nansum", "quantile", "histogram",
    "bincount", "clip_by_norm", "logcumsumexp", "trapezoid", "renorm",
    "increment", "tanh_"]


_HALF = (torch.bfloat16, torch.float16)

# --------------------------------------------------------------------------
# binary elementwise
# --------------------------------------------------------------------------

def _binary(fname, tfn):
    def op(x, y, name=None):
        return apply(tfn, *_operands(x, y), name=fname)
    op.__name__ = op.__qualname__ = fname
    return op


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.sub)
multiply = _binary("multiply", torch.mul)
divide = _binary("divide", torch.true_divide)
floor_divide = _binary("floor_divide", torch.floor_divide)
remainder = _binary("remainder", torch.remainder)
mod = remainder
floor_mod = remainder
pow = _binary("pow", torch.pow)
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
atan2 = _binary("atan2", torch.atan2)
heaviside = _binary("heaviside", lambda a, b: torch.heaviside(a, b.to(a.dtype)))
hypot = _binary("hypot", torch.hypot)
logaddexp = _binary("logaddexp", torch.logaddexp)
nextafter = _binary("nextafter",
                    lambda a, b: torch.nextafter(a, b.to(a.dtype)))
copysign = _binary("copysign", torch.copysign)
gcd = _binary("gcd", torch.gcd)
lcm = _binary("lcm", torch.lcm)


def elementwise_add(x, y, axis=-1, name=None):
    return add(x, y)


def elementwise_sub(x, y, axis=-1, name=None):
    return subtract(x, y)


def elementwise_mul(x, y, axis=-1, name=None):
    return multiply(x, y)


def elementwise_div(x, y, axis=-1, name=None):
    return divide(x, y)


# --------------------------------------------------------------------------
# unary elementwise
# --------------------------------------------------------------------------

def _unary(fname, tfn):
    def op(x, name=None):
        return apply(tfn, _t(x), name=fname)
    op.__name__ = op.__qualname__ = fname
    return op


sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", torch.rsqrt)
square = _unary("square", torch.square)
exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
abs = _unary("abs", torch.abs)
ceil = _unary("ceil", torch.ceil)
floor = _unary("floor", torch.floor)
round = _unary("round", torch.round)
trunc = _unary("trunc", torch.trunc)
frac = _unary("frac", lambda a: a - torch.trunc(a))
sign = _unary("sign", torch.sign)
neg = _unary("neg", torch.neg)
reciprocal = _unary("reciprocal", lambda a: 1.0 / a)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
asinh = _unary("asinh", torch.asinh)
acosh = _unary("acosh", torch.acosh)
atanh = _unary("atanh", torch.atanh)
erf = _unary("erf", torch.erf)
erfinv = _unary("erfinv", torch.erfinv)
lgamma = _unary("lgamma", torch.lgamma)
digamma = _unary("digamma", torch.digamma)
i0 = _unary("i0", torch.special.i0)
i1 = _unary("i1", torch.special.i1)
deg2rad = _unary("deg2rad", torch.deg2rad)
rad2deg = _unary("rad2deg", torch.rad2deg)
isnan = _unary("isnan", torch.isnan)
isinf = _unary("isinf", torch.isinf)
isfinite = _unary("isfinite", torch.isfinite)
logit = _unary("logit", lambda a: torch.log(a / (1 - a)))
sigmoid = _unary("sigmoid", torch.sigmoid)


def clip(x, min=None, max=None, name=None):
    lo = min.item() if torch.is_tensor(min) else min
    hi = max.item() if torch.is_tensor(max) else max
    return apply(lambda a: torch.clamp(a, lo, hi), _t(x), name="clip")


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply(lambda a: torch.nan_to_num(a, nan=nan, posinf=posinf,
                                            neginf=neginf),
                 _t(x), name="nan_to_num")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    s = scale.item() if torch.is_tensor(scale) else scale

    def _scale(a):
        return a * s + bias if bias_after_scale else (a + bias) * s

    out = apply(_scale, _t(x), name="scale")
    if act is not None:
        from ..nn import functional as F
        out = getattr(F, act)(out)
    return out


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply(lambda a: scale_b * torch.tanh(scale_a * a), _t(x),
                 name="stanh")


def multiplex(inputs, index, name=None):
    """Row ``i`` of the output is row ``i`` of ``inputs[index[i]]``."""
    def _mux(idx, *arrs):
        stacked = torch.stack(arrs, 0)
        rows = torch.arange(stacked.shape[1], device=stacked.device)
        return stacked[idx.reshape(-1).long(), rows]
    return apply(_mux, _t(index), *[_t(a) for a in inputs], name="multiplex")


# --------------------------------------------------------------------------
# reductions
# --------------------------------------------------------------------------

def _keep(out, a, ax, keepdim):
    """``out`` reduced over ``ax`` of ``a`` with the reduced dims put
    back as size 1 when ``keepdim``."""
    if not keepdim:
        return out
    shape = [1 if d in _dims(ax, a.dim()) else s
             for d, s in enumerate(a.shape)]
    return out.reshape(shape)


def _float(a):
    return a if a.is_floating_point() or a.is_complex() \
        else a.to(default_float_dtype())


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    d = convert_dtype(dtype)
    ax = _axis_arg(axis)
    return apply(lambda a: torch.sum(a, dim=_dims(ax, a.dim()),
                                     keepdim=keepdim, dtype=d)
                 if a.dim() else a.to(d or a.dtype),
                 _t(x), name="reduce_sum")


def mean(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return apply(lambda a: torch.mean(_float(a), dim=_dims(ax, a.dim()),
                                      keepdim=keepdim) if a.dim()
                 else _float(a), _t(x), name="reduce_mean")


def max(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return apply(lambda a: torch.amax(a, dim=_dims(ax, a.dim()),
                                      keepdim=keepdim),
                 _t(x), name="reduce_max")


def min(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return apply(lambda a: torch.amin(a, dim=_dims(ax, a.dim()),
                                      keepdim=keepdim),
                 _t(x), name="reduce_min")


amax = max
amin = min


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    """16-bit inputs multiply in f32 and round once, as ``cumsum`` and
    ``cumprod`` accumulate."""
    d = convert_dtype(dtype)
    ax = _axis_arg(axis)

    def _prod(a):
        half = d is None and a.dtype in _HALF
        out = a.float() if half else (a if d is None else a.to(d))
        for dim in sorted(_dims(ax, a.dim()), reverse=True):
            out = torch.prod(out, dim=dim, keepdim=keepdim)
        return out.to(a.dtype) if half else out

    return apply(_prod, _t(x), name="reduce_prod")


def logsumexp(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return apply(lambda a: torch.logsumexp(a, dim=_dims(ax, a.dim()),
                                           keepdim=keepdim),
                 _t(x), name="logsumexp")


def all(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return apply(lambda a: _keep(a.bool().all() if ax is None else
                                 torch.all(a.bool(), dim=_dims(ax, a.dim())),
                                 a, ax, keepdim),
                 _t(x), name="reduce_all")


def any(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return apply(lambda a: _keep(a.bool().any() if ax is None else
                                 torch.any(a.bool(), dim=_dims(ax, a.dim())),
                                 a, ax, keepdim),
                 _t(x), name="reduce_any")


def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return apply(lambda a: _keep(torch.count_nonzero(a, dim=_dims(
        ax, a.dim())), a, ax, keepdim), _t(x), name="count_nonzero")


def cumsum(x, axis=None, dtype=None, name=None):
    """16-bit inputs accumulate in f32 and round once (the card and the
    CPU then agree to the output's rounding)."""
    d = convert_dtype(dtype)

    def _cumsum(a):
        arr = a.reshape(-1) if axis is None else a
        ax = 0 if axis is None else int(axis)
        if d is None and a.dtype in _HALF:
            return torch.cumsum(arr, ax, dtype=torch.float32).to(a.dtype)
        return torch.cumsum(arr, ax, dtype=d)

    return apply(_cumsum, _t(x), name="cumsum")


def cumprod(x, dim=None, dtype=None, name=None):
    d = convert_dtype(dtype)

    def _cumprod(a):
        arr = a.reshape(-1) if dim is None else a
        ax = 0 if dim is None else int(dim)
        if d is None and a.dtype in _HALF:
            return torch.cumprod(arr, ax, dtype=torch.float32).to(a.dtype)
        return torch.cumprod(arr, ax, dtype=d)

    return apply(_cumprod, _t(x), name="cumprod")


def _cum_extremum(x, axis, dtype, largest, opname):
    """``(values, indices)``: the running extremum along ``axis``
    (flattened when None) and where it was attained, the later index on a
    tie (the JAX scan takes the right operand when it is >= / <=)."""
    idx_dt = convert_dtype(dtype)

    def _cm(a):
        arr = a.reshape(-1) if axis is None else a
        ax = 0 if axis is None else int(axis) % arr.dim()
        vals, idx = (torch.cummax if largest else torch.cummin)(arr, ax)
        return vals, idx.to(idx_dt)

    return apply(_cm, _t(x), name=opname)


def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extremum(x, axis, dtype, True, "cummax")


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extremum(x, axis, dtype, False, "cummin")


def add_n(inputs, name=None):
    if torch.is_tensor(inputs):
        return inputs
    xs = [_t(v) for v in inputs]

    def _add_n(*arrs):
        out = arrs[0]
        for a in arrs[1:]:
            out = out + a
        return out

    return apply(_add_n, *xs, name="add_n")


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = _t(x)

    def _edge(e):
        if e is None or torch.is_tensor(e):
            return e
        e = torch.as_tensor(e, dtype=x.dtype, device=x.device)
        if e.dim() == 0:
            shape = list(x.shape)
            shape[axis] = 1
            e = e.expand(shape)
        return e

    return apply(lambda a: torch.diff(a, n, axis, _edge(prepend),
                                      _edge(append)), x, name="diff")


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply(lambda a: torch.diagonal(a, offset, axis1, axis2).sum(-1),
                 _t(x), name="trace")


def lerp(x, y, weight, name=None):
    if torch.is_tensor(weight):
        return apply(lambda a, b, w: a + w * (b - a), _t(x), _t(y), weight,
                     name="lerp")
    return apply(lambda a, b: a + weight * (b - a), _t(x), _t(y), name="lerp")


def kron(x, y, name=None):
    return apply(torch.kron, _t(x), _t(y), name="kron")


def inner(x, y, name=None):
    return apply(torch.inner, _t(x), _t(y), name="inner")


def outer(x, y, name=None):
    return apply(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)),
                 _t(x), _t(y), name="outer")


# --------------------------------------------------------------------------
# matrix math
# --------------------------------------------------------------------------

def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def _mm(a, b):
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return apply(_mm, _t(x), _t(y), name="matmul")


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return apply(torch.bmm, _t(x), _t(y), name="bmm")


def dot(x, y, name=None):
    """Of vectors, their dot product; of ``[B, N]`` matrices, the dot
    product of each row pair."""
    return apply(lambda a, b: (a * b).sum(-1) if a.dim() == 2
                 else torch.dot(a, b), _t(x), _t(y), name="dot")


def mv(x, y, name=None):
    return apply(torch.matmul, _t(x), _t(y), name="mv")


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply(lambda i, a, b: beta * i + alpha * torch.matmul(a, b),
                 _t(input), _t(x), _t(y), name="addmm")


# --------------------------------------------------------------------------
# stats
# --------------------------------------------------------------------------

def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return apply(lambda a: torch.std(_float(a), dim=_dims(ax, a.dim()),
                                     correction=int(bool(unbiased)),
                                     keepdim=keepdim), _t(x), name="std")


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return apply(lambda a: torch.var(_float(a), dim=_dims(ax, a.dim()),
                                     correction=int(bool(unbiased)),
                                     keepdim=keepdim), _t(x), name="var")


def _to_last(a, ax):
    """``a`` with the dims of ``ax`` (None: all) moved to the end and
    flattened into one: ``(moved, kept_shape)``."""
    red = _dims(ax, a.dim())
    keep = [d for d in range(a.dim()) if d not in red]
    moved = a.permute(*keep, *red) if a.dim() else a.reshape(1)
    return moved.reshape(*[a.shape[d] for d in keep], -1), \
        [a.shape[d] for d in keep]


def _middle(a, ax, keepdim, skip_nan):
    """The median of ``a`` over ``ax``: the mean of the two middle values
    of an even count (``jnp.median``); with ``skip_nan`` over the non-NaN
    values (``jnp.nanmedian``: NaN where there are none)."""
    a = _float(a)
    flat, _ = _to_last(a, ax)
    nan = torch.isnan(flat)
    # NaN as +inf: the card's bf16 sort does not put NaN last
    srt = torch.sort(torch.where(nan, torch.inf, flat), dim=-1).values
    if skip_nan:
        n = (~nan).sum(-1, keepdim=True)
    else:
        n = torch.full(flat.shape[:-1] + (1,), flat.shape[-1],
                       device=flat.device)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    out = (srt.gather(-1, lo) + srt.gather(-1, hi)) / 2
    if skip_nan:
        out = torch.where(n > 0, out, torch.nan)
    else:
        out = torch.where(nan.any(-1, keepdim=True), torch.nan, out)
    return _keep(out.squeeze(-1), a, ax, keepdim)


def median(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return apply(lambda a: _middle(a, ax, keepdim, False), _t(x),
                 name="median")


def nanmedian(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return apply(lambda a: _middle(a, ax, keepdim, True), _t(x),
                 name="nanmedian")


def nanmean(x, axis=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    return apply(lambda a: torch.nanmean(_float(a), dim=_dims(ax, a.dim()),
                                         keepdim=keepdim),
                 _t(x), name="nanmean")


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    ax = _axis_arg(axis)
    d = convert_dtype(dtype)
    return apply(lambda a: torch.nansum(a, dim=_dims(ax, a.dim()),
                                        keepdim=keepdim, dtype=d),
                 _t(x), name="nansum")


def quantile(x, q, axis=None, keepdim=False, name=None):
    """Linear interpolation; a list of ``q`` puts its dim first."""
    ax = _axis_arg(axis)

    def _quantile(a):
        a = _float(a)
        # torch.quantile takes f32 / f64 only: 16-bit runs in f32
        wide = a.float() if a.dtype in _HALF else a
        qt = torch.as_tensor(q.tolist() if torch.is_tensor(q) else q,
                             dtype=wide.dtype, device=a.device)
        flat, _ = _to_last(wide, ax)
        out = torch.quantile(flat, qt, dim=-1)
        if keepdim:
            shape = [1 if d in _dims(ax, a.dim()) else s
                     for d, s in enumerate(a.shape)]
            out = out.reshape(tuple(qt.shape) + tuple(shape))
        return out.to(a.dtype)

    return apply(_quantile, _t(x), name="quantile")


def histogram(x, bins=100, min=0, max=0, name=None):
    """f32 counts of ``bins`` equal bins over ``[min, max]`` (the data's
    own range, read back to the host, when both are 0); the last bin
    holds ``max``."""
    a = _t(x)
    lo, hi = (min, max) if (min != 0 or max != 0) else (
        float(a.min()), float(a.max()))
    return torch.histc(a.float(), bins=int(bins), min=float(lo),
                       max=float(hi))


def bincount(x, weights=None, minlength=0, name=None):
    x = _t(x)
    w = weights if weights is None or torch.is_tensor(weights) \
        else torch.as_tensor(weights, device=x.device)
    return torch.bincount(x.reshape(-1).long(), w, int(minlength))


def clip_by_norm(x, max_norm, name=None):
    """``x`` scaled down so its L2 norm (in f32) is at most
    ``max_norm``."""
    def fn(a):
        norm = torch.sqrt(torch.clamp((a.float() ** 2).sum(), min=1e-12))
        return a * torch.clamp(max_norm / norm, max=1.0).to(a.dtype)

    return apply(fn, _t(x), name="clip_by_norm")


def logcumsumexp(x, axis=None, dtype=None, name=None):
    d = convert_dtype(dtype)

    def fn(a):
        arr = a.reshape(-1) if axis is None else a
        ax = 0 if axis is None else int(axis) % arr.dim()
        out = torch.logcumsumexp(arr.float(), ax)
        return out.to(d or a.dtype) if a.is_floating_point() else out

    return apply(fn, _t(x), name="logcumsumexp")


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return apply(lambda ya, xa: torch.trapezoid(ya, xa, dim=axis),
                     _t(y), _t(x), name="trapezoid")
    step = 1.0 if dx is None else float(dx)
    return apply(lambda ya: torch.trapezoid(ya, dx=step, dim=axis), _t(y),
                 name="trapezoid")


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along ``axis`` whose p-norm exceeds ``max_norm`` scaled
    down to it."""
    def fn(a):
        red = tuple(i for i in range(a.dim()) if i != axis % a.dim())
        norms = (a.float().abs() ** p).sum(red, keepdim=True) ** (1.0 / p)
        s = torch.where(norms > max_norm,
                        max_norm / torch.clamp(norms, min=1e-12), 1.0)
        return a * s.to(a.dtype)

    return apply(fn, _t(x), name="renorm")


def increment(x, value=1.0, name=None):
    """Add ``value`` to the one-element tensor ``x`` in place and return
    it (the loop-counter op)."""
    if x.numel() != 1:
        raise ValueError(
            f"increment expects a 1-element tensor, got shape "
            f"{tuple(x.shape)}")
    with torch.no_grad():
        x.add_(value)
    return x


def tanh_(x, name=None):
    from ..nn.functional.activation import tanh_ as _tanh_
    return _tanh_(x)

