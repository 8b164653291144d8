"""Explicit random generators (counterpart of ``paddle_tpu/core/random.py``).

The JAX package keeps one global key; the port hands a
``torch.Generator`` to whatever draws random numbers.
"""
from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["seed"]


def seed(n: int, device=None) -> torch.Generator:
    """A generator on ``device`` (default: the CUDA device) seeded with
    ``n``."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(n))
    return g
