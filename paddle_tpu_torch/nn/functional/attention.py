"""Attention entry points (counterpart of
``paddle_tpu/nn/functional/attention.py``).

``flash_attention`` routes to ``ops.flash_attention``: the Hopper
kernels (forward, and the dq and dk/dv backward under autograd) for
CUDA tensors, their plain versions for CPU tensors.  There is no route
to a library attention.  Attention dropout in training runs inside the
same kernels (their dropout forms): the JAX package leaves it to its
composite (``_sdpa_reference``: ``bernoulli(key, 1 - p)`` on the
probabilities, then ``/ (1 - p)``), which the port does not have on the
card.  The bits are the port's own Philox bits, drawn afresh on every
call from the device's default generator.
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
    ``[B, S, H, D]``.  ``dropout`` in [0, 1) drops attention
    probabilities in training; in eval, or at 0, the call is the one
    without dropout."""
    return ops.flash_attention(query, key, value, causal=causal,
                               kv_mask=kv_mask,
                               dropout_p=dropout if training else 0.0)
