"""Attention entry points (counterpart of
``paddle_tpu/nn/functional/attention.py``).

``scaled_dot_product_attention`` is Paddle's masked attention, the
composite: einsum, softmax, einsum in plain PyTorch (the JAX package's
``_sdpa_reference``: scores in f32, a boolean mask keeps where True and
an additive one is added, probabilities cast to q's dtype, dropout on
them).  It is never a library attention.

``flash_attention`` routes each call by its shapes, dtype and device,
decided before anything launches:
- CUDA tensors with ``Sq == Sk``, D in {64, 128}, ``H % Hkv == 0``, q,
  k and v all bf16 or all fp16, and ``return_softmax`` false go to
  ``ops.flash_attention``: the Hopper kernels (rows 1-3: forward, and the
  dq and dk/dv backward under autograd);
- CPU tensors with ``Sq == Sk`` and ``return_softmax`` false go to the
  same op, whose CPU form is the kernels' plain version;
- every other call takes the composite above (GQA heads expanded,
  ``kv_mask`` as an additive bias).

This follows the JAX predicate (``ops/flash_attention.py:744-746``)
with two deliberate differences:
- **Dropout.** Attention dropout in training goes to the kernels'
  dropout forms (their own Philox bits, drawn afresh on every call from
  the device's default generator), where the JAX package sends any
  dropout to its composite;
- **Ragged S.** S need not be a multiple of 128: the port's kernels
  mask the ragged edge.

``COMPOSITE`` counts the composite's calls on CUDA tensors: calls of
``scaled_dot_product_attention`` and ``flash_attention`` calls the route
sends there.  It sits beside the kernels' launch counts
(``ops.LAUNCHERS``) so a run can show which attention its path took.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ... import ops
from ...ops._build import LaunchCounter
from ...amp.auto_cast import cast_inputs

__all__ = ["scaled_dot_product_attention", "flash_attention", "COMPOSITE",
           "kernel_route"]

_NEG = -1e30


COMPOSITE = LaunchCounter("attention_composite")


def _composite(q, k, v, mask=None, dropout_p=0.0, is_causal=False,
               scale=None):
    """q ``[B, Sq, H, D]``, k/v ``[B, Sk, H, D]``: scores in f32, the
    causal cut and ``mask`` (bool: keep where True; float: added),
    softmax, probabilities in q's dtype, dropout, product with v."""
    if q.is_cuda:
        COMPOSITE.add()
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * s
    if is_causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(
            sk - sq)
        scores = scores.masked_fill(~keep, _NEG)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, _NEG)
        else:
            scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, device=probs.device) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(probs.dtype)) \
        .to(q.dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, name=None):
    """Paddle's masked attention over ``[B, S, H, D]`` inputs
    (``attn_mask`` broadcast to ``[B, H, Sq, Sk]``)."""
    query, key, value, attn_mask = cast_inputs(
        "scaled_dot_product_attention", query, key, value, attn_mask)
    return _composite(query, key, value, attn_mask,
                      dropout_p if training else 0.0, is_causal, scale)


def kernel_route(query, key, value, return_softmax=False) -> bool:
    """Whether ``flash_attention`` sends these tensors to
    ``ops.flash_attention`` (a pure function of shapes, dtypes and
    device)."""
    b, s, h, d = query.shape
    same_len = key.shape[1] == s and not return_softmax
    if query.device.type != "cuda":
        return same_len
    return (same_len and d in (64, 128) and key.shape[2] > 0
            and h % key.shape[2] == 0
            and query.dtype in (torch.bfloat16, torch.float16)
            and key.dtype == query.dtype and value.dtype == query.dtype)


def flash_attention(query: torch.Tensor, key: torch.Tensor,
                    value: torch.Tensor, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False,
                    training: bool = True,
                    kv_mask: Optional[torch.Tensor] = None, name=None):
    """q ``[B, S, H, D]``, k/v ``[B, S, Hkv, D]`` (GQA native); returns
    ``[B, S, H, D]`` (with ``return_softmax``: ``(out, None)``).
    ``dropout`` in [0, 1) drops attention probabilities in training; in
    eval, or at 0, the call is the one without dropout.  ``kv_mask``
    ``[B, S]``: 1 attends, 0 is padding."""
    query, key, value = cast_inputs("flash_attention", query, key, value)
    p = dropout if training else 0.0
    if kernel_route(query, key, value, return_softmax):
        return ops.flash_attention(query, key, value, causal=causal,
                                   kv_mask=kv_mask, dropout_p=p)
    h, hkv = query.shape[2], key.shape[2]
    if h != hkv:
        key = key.repeat_interleave(h // hkv, dim=2)
        value = value.repeat_interleave(h // hkv, dim=2)
    bias = None
    if kv_mask is not None:
        bias = torch.where(kv_mask[:, None, None, :] > 0, 0.0, _NEG).to(
            torch.float32)
    out = _composite(query, key, value, bias, p, causal)
    return (out, None) if return_softmax else out
