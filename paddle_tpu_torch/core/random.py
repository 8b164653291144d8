"""Explicit random generators (counterpart of ``paddle_tpu/core/random.py``).

The JAX package keeps one global key; the port hands a
``torch.Generator`` to whatever draws random numbers.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device

__all__ = ["seed", "philox_pair"]


def seed(n: int, device=None) -> torch.Generator:
    """A generator on ``device`` (default: the CUDA device) seeded with
    ``n``."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(n))
    return g


def philox_pair(device=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The Philox ``(seed, offset)`` pair of one attention-dropout call:
    an int64 ``[2]`` tensor on ``device`` (default: the CUDA device),
    drawn by ``torch.randint`` from ``generator`` (default: the device's
    default generator).

    The pair stays on the device: the kernels read it through a pointer,
    so drawing it costs no host sync.  Drawn from the default generator,
    it is replayed by ``torch.utils.checkpoint``'s ``preserve_rng_state``
    when a recomputed region runs its forward again, so the backward
    meets the forward's dropout bits."""
    return torch.randint(0, 1 << 62, (2,), generator=generator,
                         device=resolve_device(device), dtype=torch.int64)
