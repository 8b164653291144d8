"""``paddle.distribution`` (counterpart of ``paddle_tpu/distribution.py``):
``Uniform``, ``Normal``, ``Categorical`` and ``kl_divergence``.

The parameters become f32 tensors (on the device of a tensor given,
the layer API's current device for numbers and arrays: the card unless
``set_device("cpu")``), and every method is tensor arithmetic on them.
``sample(shape, seed=0)`` draws from the port's generator on that device
(``core.random.get_generator``), so each call draws afresh as the JAX
package's ``next_key`` does; a nonzero ``seed`` draws from a
``torch.Generator`` seeded with it, so the same seed gives the same
sample.  The two packages' samples agree in distribution, not bit for
bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .core.random import get_generator
from .device import current_device

__all__ = ["Distribution", "Uniform", "Normal", "Categorical",
           "kl_divergence"]


def _arr(x, dtype=torch.float32):
    """``x`` as a tensor, floating and integer values cast to ``dtype``;
    numbers and arrays go to the current device."""
    t = (x.detach() if torch.is_tensor(x)
         else torch.as_tensor(np.asarray(x), device=current_device()))
    return t if t.dtype == torch.bool else t.to(dtype)


def _generator(seed, device) -> torch.Generator:
    """Seed 0: the port's generator on ``device`` (a fresh draw each
    call); else a generator seeded with ``seed``."""
    if not seed:
        return get_generator(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


class Distribution:
    def sample(self, shape=(), seed=0):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        return torch.exp(_arr(self.log_prob(value)))

    def kl_divergence(self, other) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def _extend(shape, base):
        return tuple(shape) + tuple(base)


class Uniform(Distribution):
    """U[low, high)."""

    def __init__(self, low, high, name=None):
        self.low = _arr(low)
        self.high = _arr(high)

    def sample(self, shape=(), seed=0):
        base = torch.broadcast_shapes(self.low.shape, self.high.shape)
        u = torch.rand(self._extend(shape, base), dtype=torch.float32,
                       device=self.low.device,
                       generator=_generator(seed, self.low.device))
        return self.low + u * (self.high - self.low)

    def entropy(self):
        return torch.log(self.high - self.low)

    def log_prob(self, value):
        v = _arr(value).to(self.low.device)
        inside = (v >= self.low) & (v < self.high)
        lp = -torch.log(self.high - self.low)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))


class Normal(Distribution):
    """N(loc, scale^2)."""

    def __init__(self, loc, scale, name=None):
        self.loc = _arr(loc)
        self.scale = _arr(scale)

    def sample(self, shape=(), seed=0):
        base = torch.broadcast_shapes(self.loc.shape, self.scale.shape)
        eps = torch.randn(self._extend(shape, base), dtype=torch.float32,
                          device=self.loc.device,
                          generator=_generator(seed, self.loc.device))
        return self.loc + eps * self.scale

    def entropy(self):
        return (0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale)
                + torch.zeros_like(self.loc))

    def log_prob(self, value):
        v = _arr(value).to(self.loc.device)
        var = self.scale ** 2
        return (-((v - self.loc) ** 2) / (2 * var) - torch.log(self.scale)
                - 0.5 * math.log(2 * math.pi))

    def kl_divergence(self, other: "Normal") -> torch.Tensor:
        """KL(self || other)."""
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))


class Categorical(Distribution):
    """Categorical over unnormalized logits (last dim)."""

    def __init__(self, logits, name=None):
        self.logits = _arr(logits)
        self._log_p = torch.log_softmax(self.logits, dim=-1)

    def sample(self, shape=(), seed=0):
        n = int(np.prod(shape)) if len(shape) else 1
        batch = self.logits.shape[:-1]
        flat = self._log_p.exp().reshape(-1, self.logits.shape[-1])
        draws = torch.multinomial(
            flat, n, replacement=True,
            generator=_generator(seed, self.logits.device))   # [R, n]
        return draws.T.reshape(tuple(shape) + tuple(batch))

    def entropy(self):
        p = torch.exp(self._log_p)
        return -torch.sum(p * self._log_p, dim=-1)

    def log_prob(self, value):
        v = _arr(value, dtype=torch.int64).to(self.logits.device)
        return torch.take_along_dim(self._log_p, v[..., None],
                                    dim=-1)[..., 0]

    def kl_divergence(self, other: "Categorical") -> torch.Tensor:
        p = torch.exp(self._log_p)
        return torch.sum(p * (self._log_p - other._log_p), dim=-1)


def kl_divergence(p: Distribution, q: Distribution) -> torch.Tensor:
    """``paddle.distribution.kl_divergence``: ``p.kl_divergence(q)``."""
    return p.kl_divergence(q)
