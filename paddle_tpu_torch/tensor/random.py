"""Random sampling (counterpart of ``paddle_tpu/tensor/random.py``).

Draws come from explicit ``torch.Generator`` objects: ``generator`` when
it is given, else the layer API's generator of the device
(``core.random.get_generator``), which ``paddle.seed`` restarts, so a
seeded program draws the same numbers again.  ``seed=n`` (non-zero) in
``uniform`` / ``uniform_`` draws from a generator seeded with ``n``
alone.  The bits are not JAX's; shapes, dtypes, ranges and moments are.
A new tensor lands on the current device or on ``device``.
"""
from __future__ import annotations

import torch

from ..core.dtype import convert_dtype, default_float_dtype
from ..core.random import get_generator, seed as _seeded
from ..device import current_device, resolve_device
from ._util import ints as _ints, tensor as _t

__all__ = ["uniform", "uniform_", "rand", "randn", "standard_normal",
           "normal", "normal_", "gaussian", "randint", "randint_like",
           "randperm", "shuffle", "bernoulli", "bernoulli_", "multinomial",
           "poisson", "exponential_", "binomial"]


def _dev(device):
    return current_device() if device is None else resolve_device(device)


def _gen(generator, device):
    return get_generator(device) if generator is None else generator


def _fdt(dtype):
    d = convert_dtype(dtype)
    return d if d is not None else default_float_dtype()


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None, *,
            device=None, generator=None):
    dev = _dev(device)
    g = _seeded(seed, dev) if seed else _gen(generator, dev)
    out = torch.empty(_ints(shape), dtype=_fdt(dtype), device=dev)
    return out.uniform_(float(min), float(max), generator=g)


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None, *, generator=None):
    g = _seeded(seed, x.device) if seed else _gen(generator, x.device)
    with torch.no_grad():
        return x.uniform_(float(min), float(max), generator=g)


def rand(shape, dtype=None, name=None, *, device=None, generator=None):
    return uniform(shape, dtype, 0.0, 1.0, device=device, generator=generator)


def randn(shape, dtype=None, name=None, *, device=None, generator=None):
    dev = _dev(device)
    return torch.randn(_ints(shape), dtype=_fdt(dtype), device=dev,
                       generator=_gen(generator, dev))


def standard_normal(shape, dtype=None, name=None, *, device=None,
                    generator=None):
    return randn(shape, dtype, device=device, generator=generator)


def normal(mean=0.0, std=1.0, shape=None, name=None, *, device=None,
           generator=None):
    """``mean + std * N(0, 1)``; tensor ``mean`` / ``std`` broadcast
    together and give the shape and device."""
    if torch.is_tensor(mean) or torch.is_tensor(std):
        t = mean if torch.is_tensor(mean) else std
        out_shape = torch.broadcast_shapes(
            tuple(getattr(mean, "shape", ())), tuple(getattr(std, "shape", ())))
        dev = t.device
    else:
        out_shape, dev = _ints(shape), _dev(device)
    z = torch.randn(out_shape, dtype=default_float_dtype(), device=dev,
                    generator=_gen(generator, dev))
    return mean + std * z


def normal_(x, mean=0.0, std=1.0, name=None, *, generator=None):
    with torch.no_grad():
        return x.normal_(mean, std, generator=_gen(generator, x.device))


def gaussian(shape, mean=0.0, std=1.0, dtype=None, name=None, *,
             device=None, generator=None):
    dev = _dev(device)
    out = torch.empty(_ints(shape), dtype=_fdt(dtype), device=dev)
    return out.normal_(mean, std, generator=_gen(generator, dev))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None, *,
            device=None, generator=None):
    """Integers in ``[low, high)`` (``[0, low)`` when ``high`` is
    None)."""
    if high is None:
        low, high = 0, low
    dev = _dev(device)
    return torch.randint(int(low), int(high), _ints(shape),
                         dtype=convert_dtype(dtype), device=dev,
                         generator=_gen(generator, dev))


def randint_like(x, low=0, high=None, dtype=None, name=None, *,
                 generator=None):
    if high is None:
        low, high = 0, low
    d = convert_dtype(dtype) if dtype is not None else x.dtype
    return torch.randint(int(low), int(high), tuple(x.shape),
                         device=x.device,
                         generator=_gen(generator, x.device)).to(d)


def randperm(n, dtype="int64", name=None, *, device=None, generator=None):
    dev = _dev(device)
    return torch.randperm(int(n), dtype=convert_dtype(dtype), device=dev,
                          generator=_gen(generator, dev))


def shuffle(x, axis=0, name=None, *, generator=None):
    """``x`` with its slices along ``axis`` in a random order."""
    x = _t(x)
    perm = torch.randperm(x.shape[axis], device=x.device,
                          generator=_gen(generator, x.device))
    return torch.index_select(x, axis, perm)


def bernoulli(x, name=None, *, generator=None):
    """0 / 1 draws with probabilities ``x``, in ``x``'s dtype."""
    x = _t(x)
    return torch.bernoulli(x.float(),
                           generator=_gen(generator, x.device)).to(x.dtype)


def bernoulli_(x, p=0.5, name=None, *, generator=None):
    with torch.no_grad():
        return x.bernoulli_(p, generator=_gen(generator, x.device))


def multinomial(x, num_samples=1, replacement=False, name=None, *,
                generator=None):
    """int64 draws of categories by the (unnormalized) weights ``x``:
    ``[num_samples]`` of a vector, ``[B, num_samples]`` of rows."""
    x = _t(x)
    return torch.multinomial(x.float(), num_samples, replacement,
                             generator=_gen(generator, x.device))


def poisson(x, name=None, *, generator=None):
    x = _t(x)
    return torch.poisson(x.float(),
                         generator=_gen(generator, x.device)).to(x.dtype)


def exponential_(x, lam=1.0, name=None, *, generator=None):
    with torch.no_grad():
        return x.exponential_(lam, generator=_gen(generator, x.device))


def binomial(count, prob, name=None, *, generator=None):
    """int64 successes of ``count`` trials at ``prob``."""
    c, p = _t(count), _t(prob)
    c, p = torch.broadcast_tensors(c.float(), p.float())
    return torch.binomial(c, p,
                          generator=_gen(generator, c.device)).to(torch.int64)
