"""Weight normalization (counterpart of
``paddle_tpu/nn/utils/weight_norm_hook.py``): ``weight_norm`` /
``remove_weight_norm``.

``layer.<name>`` becomes ``g * v / ||v||``, the norm taken over every
dimension except ``dim`` (over all of them when ``dim`` is None).  As in
Paddle, the parameter is replaced by ``<name>_g`` and ``<name>_v``, and a
forward pre-hook recomputes ``<name>`` from them before each call, so
gradients reach ``g`` and ``v``.  The norm is taken in f32.
"""
from __future__ import annotations

import torch

from ...core.tensor import Parameter

__all__ = ["weight_norm", "remove_weight_norm"]


def _norm_except_dim(v, dim):
    """``||v||`` in f32 over every dim but ``dim`` (kept as size 1)."""
    v32 = v.float()
    if dim is None:
        return v32.pow(2).sum().sqrt()
    axes = [i for i in range(v.dim()) if i != dim % v.dim()]
    return v32.pow(2).sum(dim=axes, keepdim=True).sqrt()


def _compute_weight(g, v, dim):
    return (g.float() * v.float() / _norm_except_dim(v, dim)).to(v.dtype)


class _WeightNormHook:
    def __init__(self, name, dim):
        self.name = name
        self.dim = dim

    def __call__(self, layer, inputs):
        g = getattr(layer, self.name + "_g")
        v = getattr(layer, self.name + "_v")
        setattr(layer, self.name, _compute_weight(g, v, self.dim))
        return None


def weight_norm(layer, name="weight", dim=0):
    """Reparameterize ``layer.<name>`` as ``g * v / ||v||``; returns the
    layer."""
    if name in getattr(layer, "_weight_norm_hooks", {}):
        raise ValueError(f"weight_norm already applied to {name!r}")
    w = getattr(layer, name, None)
    if w is None:
        raise ValueError(f"{type(layer).__name__} has no parameter "
                         f"{name!r}")
    with torch.no_grad():
        g0 = _norm_except_dim(w, dim)
        if dim is not None:
            g0 = g0.to(w.dtype)
        v0 = w.detach().clone()
    del layer._parameters[name]
    layer.add_parameter(name + "_g", Parameter(g0))
    layer.add_parameter(name + "_v", Parameter(v0))
    hook = _WeightNormHook(name, dim)
    handle = layer.register_forward_pre_hook(hook)
    if not hasattr(layer, "_weight_norm_hooks"):
        layer._weight_norm_hooks = {}
    layer._weight_norm_hooks[name] = (hook, handle)
    # a usable .<name> between calls (eval-time reads)
    hook(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Undo ``weight_norm``: one ``<name>`` parameter again, with the
    value ``g * v / ||v||`` had."""
    hooks = getattr(layer, "_weight_norm_hooks", {})
    if name not in hooks:
        raise ValueError(f"weight_norm was not applied to {name!r}")
    hook, handle = hooks.pop(name)
    handle.remove()
    with torch.no_grad():
        w = _compute_weight(getattr(layer, name + "_g"),
                            getattr(layer, name + "_v"), hook.dim)
    del layer._parameters[name + "_g"]
    del layer._parameters[name + "_v"]
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, Parameter(w))
    return layer
