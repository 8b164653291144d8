"""Functional bridge: a Layer as a pure function of its tensors
(counterpart of ``paddle_tpu/func.py``).

The JAX package traces a layer's forward with its parameters swapped for
function arguments; the port does the same through
``torch.func.functional_call``.  ``jit.to_static`` captures that pure
function with ``torch.export``.  Buffers are cloned before the call, so
an in-place update inside the forward (batch norm's running statistics)
lands on the clone and comes back as the new buffers, as the JAX
function returns them, and the caller's tensors stay as they were.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

__all__ = ["functional_state", "functional_call", "functional_forward",
           "functional_apply"]


def functional_state(layer: torch.nn.Module
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(params, buffers)``: the layer's live tensors by structured
    name."""
    params = dict(layer.named_parameters())
    buffers = {name: b for name, b in layer.named_buffers()
               if b is not None}
    return params, buffers


class _Method(torch.nn.Module):
    """``layer.<method>`` as a module's forward, so
    ``torch.func.functional_call`` can bind tensors for it."""

    def __init__(self, layer, method):
        super().__init__()
        self.layer = layer
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.layer, self.method)(*args, **kwargs)


def functional_call(layer: torch.nn.Module, params: Dict[str, Any],
                    buffers: Dict[str, Any], *args, training=None,
                    **kwargs):
    """Run ``layer.forward`` with ``params`` / ``buffers`` bound;
    returns ``(outputs, new_buffers)``.  ``new_buffers`` holds each
    given buffer after the call (in-place updates included) without
    touching the tensors passed in."""
    prev_mode = layer.training
    if training is not None:
        layer.train(bool(training))
    try:
        bufs = {k: v.clone() for k, v in (buffers or {}).items()}
        out = torch.func.functional_call(layer, {**params, **bufs}, args,
                                         kwargs)
        return out, bufs
    finally:
        if training is not None:
            layer.train(prev_mode)


def functional_forward(layer: torch.nn.Module, params, *args, **kwargs):
    """``functional_call`` without buffer plumbing."""
    out, _ = functional_call(layer, params, {}, *args, **kwargs)
    return out


def functional_apply(layer: torch.nn.Module, method: str,
                     params: Dict[str, Any], *args, **kwargs):
    """Run the named METHOD of ``layer`` with ``params`` bound (e.g.
    ``prefill`` / ``decode_step`` of a GPT model); arguments pass through
    untouched."""
    return torch.func.functional_call(
        _Method(layer, method), {f"layer.{k}": v for k, v in params.items()},
        args, kwargs)
