"""Attention entry points (counterpart of
``paddle_tpu/nn/functional/attention.py``).

``flash_attention`` routes to ``ops.flash_attention``: the Hopper
kernels (forward, and the dq and dk/dv backward under autograd) for
CUDA tensors, their plain versions for CPU tensors.  There is no route
to a library attention.
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import ops

__all__ = ["flash_attention"]


def flash_attention(query: torch.Tensor, key: torch.Tensor,
                    value: torch.Tensor, dropout: float = 0.0,
                    causal: bool = False, training: bool = True,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q ``[B, S, H, D]``, k/v ``[B, S, Hkv, D]`` (GQA native); returns
    ``[B, S, H, D]``.  Attention dropout in training is not supported
    yet: the JAX package leaves the kernel for its composite there."""
    if dropout and training:
        raise NotImplementedError(
            "attention dropout in training is not supported by the port's "
            "flash-attention kernels yet (see ROADMAP.md, Queue 1)")
    return ops.flash_attention(query, key, value, causal=causal,
                               kv_mask=kv_mask)
