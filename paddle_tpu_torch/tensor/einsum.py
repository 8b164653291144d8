"""Einsum (counterpart of ``paddle_tpu/tensor/einsum.py``)."""
from __future__ import annotations

import torch

from ..autograd import apply
from ._util import tensor as _t

__all__ = ["einsum"]


def einsum(equation, *operands, name=None):
    return apply(lambda *arrs: torch.einsum(equation, *arrs),
                 *[_t(o) for o in operands], name="einsum")
