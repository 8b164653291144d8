"""Shape and layout manipulation, gather and scatter (counterpart of
``paddle_tpu/tensor/manipulation.py``).

Indices may be negative and count from the end, as in the JAX
package's gathers.  ``scatter(overwrite=False)`` zeroes the indexed rows
and then adds every update (duplicates sum); with ``overwrite=True`` a
duplicated index keeps one of its updates, as in JAX (which one is not
defined).  ``unique``, ``unique_consecutive``, ``masked_select`` and
``repeat_interleave`` with a tensor of repeats have data-dependent
shapes: on the card they read a size back to the host.
"""
from __future__ import annotations

import builtins

import torch

from ..autograd import apply
from ..core.dtype import convert_dtype
from ..core.errors import InvalidArgumentError
from ._util import ints as _ints, tensor as _t

__all__ = [
    "reshape", "reshape_", "flatten", "transpose", "t", "moveaxis",
    "swapaxes", "concat", "stack", "unstack", "unbind", "split", "chunk",
    "squeeze", "unsqueeze", "flip", "rot90", "roll", "tile", "expand",
    "expand_as", "broadcast_to", "broadcast_tensors", "broadcast_shape",
    "cast", "gather", "gather_nd", "scatter", "scatter_", "scatter_nd",
    "scatter_nd_add", "index_select", "index_sample", "index_add",
    "index_put", "take_along_axis", "put_along_axis", "slice",
    "strided_slice", "shard_index", "unique", "unique_consecutive",
    "masked_select", "masked_fill", "pad", "repeat_interleave", "tensordot",
    "as_complex", "as_real", "view", "view_as", "atleast_1d", "atleast_2d",
    "atleast_3d", "crop", "squeeze_", "unsqueeze_", "crop_tensor"]


def _axis(axis):
    return int(axis.item()) if torch.is_tensor(axis) else int(axis)


def _wrap(idx, n):
    """Long indices with negative ones counted from the end."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


def reshape(x, shape, name=None):
    s = _ints(shape)
    return apply(lambda a: torch.reshape(a, s), _t(x), name="reshape")


def reshape_(x, shape, name=None):
    """In place: ``x`` itself takes the new shape (outside autograd, as
    the JAX package rebinds the tensor's array)."""
    x.data = x.data.reshape(_ints(shape))
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def _flat(a):
        if a.dim() == 0:
            return a.reshape(1)
        return torch.flatten(a, start_axis % a.dim(), stop_axis % a.dim())
    return apply(_flat, _t(x), name="flatten")


def transpose(x, perm, name=None):
    p = _ints(perm)
    return apply(lambda a: a.permute(p), _t(x), name="transpose")


def t(x, name=None):
    """Every dim reversed (``a.T``): the transpose of a matrix."""
    return apply(lambda a: a.permute(*reversed(range(a.dim()))), _t(x),
                 name="t")


def moveaxis(x, source, destination, name=None):
    return apply(lambda a: torch.movedim(a, source, destination), _t(x),
                 name="moveaxis")


def swapaxes(x, axis0, axis1, name=None):
    return apply(lambda a: torch.swapaxes(a, axis0, axis1), _t(x),
                 name="swapaxes")


def concat(x, axis=0, name=None):
    ax = _axis(axis)
    return apply(lambda *arrs: torch.cat(arrs, ax), *[_t(v) for v in x],
                 name="concat")


def stack(x, axis=0, name=None):
    return apply(lambda *arrs: torch.stack(arrs, axis), *[_t(v) for v in x],
                 name="stack")


def unstack(x, axis=0, num=None, name=None):
    return list(apply(lambda a: torch.unbind(a, axis), _t(x), name="unstack"))


def unbind(x, axis=0):
    return unstack(x, axis=axis)


def split(x, num_or_sections, axis=0, name=None):
    """A section count (it must divide the dim) or a list of sizes, one
    of which may be -1 (the rest of the dim)."""
    x = _t(x)
    ax = _axis(axis)
    dim = x.shape[ax]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise InvalidArgumentError(
                f"split: dim {dim} not divisible by {num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = list(_ints(num_or_sections))
        known = builtins.sum(s for s in sizes if s >= 0)
        sizes = [dim - known if s < 0 else s for s in sizes]
    return list(apply(lambda a: torch.split(a, sizes, ax), x, name="split"))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def squeeze(x, axis=None, name=None):
    """The size-1 dims of ``axis`` (all size-1 dims when None) dropped;
    a named dim of another size stays."""
    def _sq(a):
        if axis is None:
            return torch.squeeze(a)
        keep = tuple(ax % a.dim() for ax in _ints(axis)
                     if a.shape[ax % a.dim()] == 1)
        return torch.squeeze(a, keep) if keep else a
    return apply(_sq, _t(x), name="squeeze")


def unsqueeze(x, axis, name=None):
    axes = sorted(_ints(axis))

    def _unsq(a):
        for ax in axes:
            a = torch.unsqueeze(a, ax)
        return a
    return apply(_unsq, _t(x), name="unsqueeze")


def flip(x, axis, name=None):
    axes = _ints(axis)
    return apply(lambda a: torch.flip(a, axes), _t(x), name="flip")


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply(lambda a: torch.rot90(a, k, tuple(axes)), _t(x),
                 name="rot90")


def roll(x, shifts, axis=None, name=None):
    sh = shifts if isinstance(shifts, int) else _ints(shifts)
    ax = axis if axis is None or isinstance(axis, int) else _ints(axis)
    return apply(lambda a: torch.roll(a, sh, ax), _t(x), name="roll")


def tile(x, repeat_times, name=None):
    reps = _ints(repeat_times)
    return apply(lambda a: torch.tile(a, reps), _t(x), name="tile")


def expand(x, shape, name=None):
    """-1 keeps the input's dim."""
    s = _ints(shape)
    return apply(lambda a: a.expand(s), _t(x), name="expand")


def expand_as(x, y, name=None):
    target = tuple(_t(y).shape)
    return apply(lambda a: a.expand(target), _t(x), name="expand_as")


def broadcast_to(x, shape, name=None):
    s = _ints(shape)
    return apply(lambda a: torch.broadcast_to(a, s), _t(x),
                 name="broadcast_to")


def broadcast_tensors(inputs, name=None):
    return list(apply(lambda *arrs: torch.broadcast_tensors(*arrs),
                      *[_t(v) for v in inputs], name="broadcast_tensors"))


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def cast(x, dtype):
    d = convert_dtype(dtype)
    return apply(lambda a: a.to(d), _t(x), name="cast")


def gather(x, index, axis=0, name=None):
    """``index`` selects along ``axis`` (``jnp.take``): the output's
    shape is ``x.shape[:axis] + index.shape + x.shape[axis + 1:]``."""
    ax = _axis(axis)

    def _gather(a, i):
        d = ax % a.dim()
        out = torch.index_select(a, d, _wrap(i.reshape(-1), a.shape[d]))
        return out.reshape(a.shape[:d] + i.shape + a.shape[d + 1:])

    return apply(_gather, _t(x), _t(index), name="gather")


def _nd(idx, shape):
    """The last dim of ``idx`` as a tuple of index tensors."""
    return tuple(_wrap(idx[..., k], shape[k]) for k in range(idx.shape[-1]))


def gather_nd(x, index, name=None):
    return apply(lambda a, i: a[_nd(i, a.shape)], _t(x), _t(index),
                 name="gather_nd")


def scatter(x, index, updates, overwrite=True, name=None):
    def _sc(a, idx, upd):
        idx = (_wrap(idx.reshape(-1), a.shape[0]),)
        if overwrite:
            return a.index_put(idx, upd)
        zeroed = a.index_put(idx, torch.zeros_like(upd))
        return zeroed.index_put(idx, upd, accumulate=True)
    return apply(_sc, _t(x), _t(index), _t(updates), name="scatter")


def scatter_(x, index, updates, overwrite=True, name=None):
    out = scatter(x, index, updates, overwrite)
    with torch.no_grad():
        x.copy_(out)
    return x


def scatter_nd(index, updates, shape, name=None):
    s = _ints(shape)

    def _snd(idx, upd):
        out = torch.zeros(s, dtype=upd.dtype, device=upd.device)
        return out.index_put(_nd(idx, s), upd, accumulate=True)

    return apply(_snd, _t(index), _t(updates), name="scatter_nd")


def scatter_nd_add(x, index, updates, name=None):
    return apply(lambda a, idx, upd: a.index_put(_nd(idx, a.shape), upd,
                                                 accumulate=True),
                 _t(x), _t(index), _t(updates), name="scatter_nd_add")


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis=axis)


def index_sample(x, index):
    """``out[i, j] = x[i, index[i, j]]``."""
    def _is(a, idx):
        rows = torch.arange(a.shape[0], device=a.device)[:, None]
        return a[rows, _wrap(idx, a.shape[1])]
    return apply(_is, _t(x), _t(index), name="index_sample")


def index_add(x, index, axis, value, name=None):
    return apply(lambda a, idx, v: torch.index_add(
        a, axis, _wrap(idx, a.shape[axis]), v),
        _t(x), _t(index), _t(value), name="index_add")


def index_put(x, indices, value, accumulate=False, name=None):
    x = _t(x)
    idx = tuple(_wrap(_t(i), x.shape[k]) for k, i in enumerate(indices))
    return apply(lambda a, v: a.index_put(idx, v, accumulate=accumulate),
                 x, _t(value), name="index_put")


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return apply(lambda a, i: torch.take_along_dim(
        a, _wrap(i, a.shape[axis]), axis), _t(arr), _t(indices),
        name="take_along_axis")


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    """``reduce``: ``'assign'``, ``'add'`` or ``'multiply'`` (``'mul'``)."""
    def _pa(a, idx, v):
        idx = _wrap(idx, a.shape[axis])
        v = torch.broadcast_to(v.to(a.dtype), idx.shape)
        if reduce == "assign":
            return torch.scatter(a, axis, idx, v)
        if reduce == "add":
            return torch.scatter_add(a, axis, idx, v)
        if reduce in ("multiply", "mul"):
            return torch.scatter_reduce(a, axis, idx, v, "prod")
        raise InvalidArgumentError(f"unknown reduce {reduce}")
    return apply(_pa, _t(arr), _t(indices), _t(values), name="put_along_axis")


def slice(input, axes, starts, ends, name=None):
    """Starts and ends clamped into each dim, negative ones counted from
    its end."""
    axes, starts, ends = _ints(axes), _ints(starts), _ints(ends)

    def _slice(a):
        for ax, s, e in zip(axes, starts, ends):
            dim = a.shape[ax]
            s2 = builtins.max(0, builtins.min(s + dim if s < 0 else s, dim))
            e2 = builtins.max(s2, builtins.min(e + dim if e < 0 else e, dim))
            a = a.narrow(ax, s2, e2 - s2)
        return a

    return apply(_slice, _t(input), name="slice")


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slices ``starts[i]:ends[i]:strides[i]`` along ``axes[i]``
    (negative strides too)."""
    axes, starts, ends = _ints(axes), _ints(starts), _ints(ends)
    strides = _ints(strides)

    def _ss(a):
        for ax, s, e, st in zip(axes, starts, ends, strides):
            if st > 0:
                a = a[(builtins.slice(None),) * (ax % a.dim())
                      + (builtins.slice(s, e, st),)]
            else:  # torch slices take positive steps only
                keep = range(a.shape[ax])[builtins.slice(s, e, st)]
                a = torch.index_select(a, ax, torch.arange(
                    keep.start, keep.stop, keep.step, device=a.device)) \
                    if len(keep) else a.narrow(ax, 0, 0)
        return a

    return apply(_ss, _t(x), name="strided_slice")


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Ids of shard ``shard_id`` (of ``nshards`` equal ranges over
    ``index_num``) as offsets in it; other ids become
    ``ignore_value``."""
    size = (index_num + nshards - 1) // nshards
    return apply(lambda i: torch.where(i // size == shard_id, i % size,
                                       ignore_value),
                 _t(input), name="shard_index")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """Sorted unique values, with (in this order) the index of each one's
    first occurrence, the inverse map and the counts, in ``dtype``."""
    x = _t(x)
    d = convert_dtype(dtype)
    a = x.reshape(-1) if axis is None else x
    uniq, inv, counts = torch.unique(a, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    if not (return_index or return_inverse or return_counts):
        return uniq
    out = [uniq]
    if return_index:
        n = a.shape[0 if axis is None else axis]
        pos = torch.arange(n, device=a.device)
        first = torch.full((uniq.shape[0 if axis is None else axis],), n,
                           dtype=torch.long, device=a.device)
        out.append(first.scatter_reduce(0, inv, pos, "amin").to(d))
    if return_inverse:
        out.append(inv.reshape(x.shape if axis is None else inv.shape).to(d))
    if return_counts:
        out.append(counts.to(d))
    return tuple(out)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    x = _t(x)
    d = convert_dtype(dtype)
    a = x.reshape(-1) if axis is None else x
    uniq, inv, counts = torch.unique_consecutive(
        a, return_inverse=True, return_counts=True, dim=axis)
    out = [uniq]
    if return_inverse:
        out.append(inv.to(d))
    if return_counts:
        out.append(counts.to(d))
    return out[0] if len(out) == 1 else tuple(out)


def masked_select(x, mask, name=None):
    """The elements of flattened ``x`` where flattened ``mask`` is set;
    gradients flow back into ``x``."""
    mask = _t(mask)
    return apply(lambda a: a.reshape(-1)[mask.reshape(-1).bool()], _t(x),
                 name="masked_select")


def masked_fill(x, mask, value, name=None):
    return apply(lambda a, m: torch.where(m.bool(), value, a), _t(x),
                 _t(mask), name="masked_fill")


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``pad``: 2 * ndim widths in dim order, or 2 * k widths of the
    spatial dims of ``data_format``, innermost first."""
    from ..nn.functional.common import pad as _pad
    return _pad(_t(x), pad, mode=mode, value=value, data_format=data_format)


def repeat_interleave(x, repeats, axis=None, name=None):
    return apply(lambda a: torch.repeat_interleave(a, repeats, axis), _t(x),
                 name="repeat_interleave")


def tensordot(x, y, axes=2, name=None):
    ax = axes.tolist() if torch.is_tensor(axes) else axes
    return apply(lambda a, b: torch.tensordot(a, b, ax), _t(x), _t(y),
                 name="tensordot")


def as_complex(x, name=None):
    return apply(lambda a: torch.complex(a[..., 0], a[..., 1]), _t(x),
                 name="as_complex")


def as_real(x, name=None):
    return apply(lambda a: torch.stack([a.real, a.imag], -1), _t(x),
                 name="as_real")


def view(x, shape_or_dtype, name=None):
    """A list reshapes; a dtype casts (values, not bits)."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return cast(x, shape_or_dtype)


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def _atleast(fn, name, inputs):
    outs = [apply(fn, _t(x), name=name) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs, name=None):
    return _atleast(torch.atleast_1d, "atleast_1d", inputs)


def atleast_2d(*inputs, name=None):
    return _atleast(torch.atleast_2d, "atleast_2d", inputs)


def atleast_3d(*inputs, name=None):
    return _atleast(torch.atleast_3d, "atleast_3d", inputs)


def crop(x, shape=None, offsets=None, name=None):
    """``x[offsets[i] : offsets[i] + shape[i]]`` along every dim; a shape
    entry of -1 keeps the rest of the dim."""
    x = _t(x)
    nd = x.dim()
    offs = [int(o) for o in (offsets if offsets is not None else [0] * nd)]
    shp = [int(s) for s in (shape if shape is not None else list(x.shape))]
    if len(offs) != nd or len(shp) != nd:
        raise ValueError(f"crop: offsets/shape must have {nd} entries")
    sizes = [x.shape[i] - offs[i] if shp[i] == -1 else shp[i]
             for i in range(nd)]
    for i in range(nd):
        if offs[i] + sizes[i] > x.shape[i]:
            raise ValueError(
                f"crop window exceeds dim {i}: {offs[i]}+{sizes[i]} > "
                f"{x.shape[i]}")

    def fn(a):
        for i in range(nd):
            a = a.narrow(i, offs[i], sizes[i])
        return a

    return apply(fn, x, name="crop")


def squeeze_(x, axis=None, name=None):
    """In place (a view op on ``x`` itself)."""
    if axis is None:
        return x.squeeze_()
    for ax in sorted((a % x.dim() for a in _ints(axis)), reverse=True):
        if x.shape[ax] == 1:
            x.squeeze_(ax)
    return x


def unsqueeze_(x, axis, name=None):
    for ax in sorted(_ints(axis)):
        x.unsqueeze_(ax)
    return x


crop_tensor = crop
