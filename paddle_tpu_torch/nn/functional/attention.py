"""Attention entry points (counterpart of
``paddle_tpu/nn/functional/attention.py``).

``flash_attention`` routes to ``ops.flash_attention``: the Hopper kernel
for CUDA tensors, its plain version for CPU tensors.  There is no route
to a library attention.
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import ops

__all__ = ["flash_attention"]


def flash_attention(query: torch.Tensor, key: torch.Tensor,
                    value: torch.Tensor, dropout: float = 0.0,
                    causal: bool = False,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q ``[B, S, H, D]``, k/v ``[B, S, Hkv, D]`` (GQA native); returns
    ``[B, S, H, D]``.  Attention dropout is not supported."""
    if dropout:
        raise NotImplementedError("attention dropout is not supported by the "
                                  "flash-attention kernel")
    return ops.flash_attention(query, key, value, causal=causal,
                               kv_mask=kv_mask)
