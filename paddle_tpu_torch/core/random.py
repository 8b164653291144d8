"""Explicit random generators (counterpart of ``paddle_tpu/core/random.py``).

The JAX package keeps one global key; the port hands a
``torch.Generator`` to whatever draws random numbers.  The layer API
(``nn.Layer.create_parameter``) draws from one explicit generator per
device, which ``set_seed`` (the package's ``seed``) reseeds together
with torch's default generators (dropout bits, attention-dropout
pairs).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device

__all__ = ["seed", "set_seed", "get_generator", "next_key",
           "philox_pair"]

# the layer API's generator per device, made at first use from _SEED
_GENERATORS = {}
_SEED = 0


def seed(n: int, device=None) -> torch.Generator:
    """A generator on ``device`` (default: the CUDA device) seeded with
    ``n``."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(n))
    return g


def set_seed(n: int) -> None:
    """``paddle.seed``: every device's layer-API generator restarts from
    ``n``, and so do torch's default generators (CPU and CUDA)."""
    global _SEED
    _SEED = int(n)
    _GENERATORS.clear()
    torch.manual_seed(_SEED)


def get_generator(device=None) -> torch.Generator:
    """The layer API's generator on ``device`` (default: the CUDA
    device), seeded by the last ``set_seed``."""
    dev = resolve_device(device)
    g = _GENERATORS.get(dev)
    if g is None:
        g = _GENERATORS[dev] = torch.Generator(device=dev)
        g.manual_seed(_SEED)
    return g


def next_key(device=None) -> torch.Generator:
    """What the op library draws from when no generator is given (the
    JAX package's ``next_key`` hands out a key): the layer API's
    generator on ``device``."""
    return get_generator(device)


def philox_pair(device=None,
                generator: Optional[torch.Generator] = None,
                like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Philox ``(seed, offset)`` pair of one attention-dropout call:
    an int64 ``[2]`` tensor on ``device`` (default: the CUDA device),
    drawn by ``torch.randint`` from ``generator`` (default: the device's
    default generator).

    The pair stays on the device: the kernels read it through a pointer,
    so drawing it costs no host sync.  Drawn from the default generator,
    it is replayed by ``torch.utils.checkpoint``'s ``preserve_rng_state``
    when a recomputed region runs its forward again, so the backward
    meets the forward's dropout bits.  Given ``like`` (and no generator)
    the pair is drawn by ops on ``like`` (the same bits): a static
    Program records them, so each run draws afresh."""
    if like is not None and generator is None:
        return torch.randint_like(like.new_empty((2,), dtype=torch.int64),
                                  0, 1 << 62)
    return torch.randint(0, 1 << 62, (2,), generator=generator,
                         device=resolve_device(device), dtype=torch.int64)
