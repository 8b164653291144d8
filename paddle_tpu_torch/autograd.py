"""``paddle.autograd`` on PyTorch's autograd (counterpart of
``paddle_tpu/autograd.py`` and ``paddle_tpu/core/autograd.py``).

The JAX package records its own tape; the port's tensors carry
PyTorch's graph, so this module maps Paddle's entry points onto it:
``backward`` and ``grad`` with Paddle's argument semantics,
``no_grad`` / ``enable_grad`` / ``set_grad_enabled`` /
``is_grad_enabled``, ``PyLayer`` / ``PyLayerContext`` on a
``torch.autograd.Function``, and ``apply``, the op library's entry (the
JAX tape's ``apply`` without the tape: inputs cast by op name under
``auto_cast``, then the function runs on the tensors themselves).
"""
from __future__ import annotations

import torch

__all__ = ["backward", "grad", "no_grad", "enable_grad",
           "set_grad_enabled", "is_grad_enabled", "PyLayer",
           "PyLayerContext", "apply"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def apply(fn, *args, name: str = ""):
    """``fn(*args)`` with the tensor arguments cast for op ``name`` under
    the thread's ``auto_cast`` (as the JAX tape's ``apply`` casts them);
    PyTorch's autograd records whatever ``fn`` does."""
    from .amp.auto_cast import cast_inputs
    return fn(*cast_inputs(name, *args))


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate into the leaves' ``.grad`` the gradients of
    ``tensors`` (a tensor or a list); a missing ``grad_tensors`` entry
    means ones of the tensor's shape."""
    tensors = _as_list(tensors)
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    grads = [torch.ones_like(t) if g is None else g
             for t, g in zip(tensors, _as_list(grad_tensors))]
    torch.autograd.backward(tensors, grads, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs`` as a list, leaving ``.grad`` untouched.  ``retain_graph``
    defaults to ``create_graph``; an input the outputs do not reach
    raises unless ``allow_unused`` (then its entry is None);
    ``create_graph=True`` returns differentiable gradients; no gradient
    flows through the tensors of ``no_grad_vars``."""
    outputs = _as_list(outputs)
    inputs = _as_list(inputs)
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    grad_outputs = [torch.ones_like(o) if g is None else g
                    for o, g in zip(outputs, _as_list(grad_outputs))]
    retain = bool(create_graph) if retain_graph is None \
        else bool(retain_graph)
    handles = [v.register_hook(torch.zeros_like)
               for v in _as_list(no_grad_vars or []) if v.requires_grad]
    try:
        got = torch.autograd.grad(outputs, inputs, grad_outputs,
                                  retain_graph=retain,
                                  create_graph=create_graph,
                                  allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    if not allow_unused and any(g is None for g in got):
        raise ValueError(
            "One of the differentiated tensors appears to not have been "
            "used in the graph; pass allow_unused=True to return None.")
    return list(got)


class PyLayerContext:
    """Passed to ``PyLayer.forward`` and ``backward``: keeps the saved
    tensors and any attribute the user sets."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *tensors):
        self._saved = tuple(tensors)

    def saved_tensor(self):
        return self._saved


class _PyLayerFunction(torch.autograd.Function):
    """One PyLayer call: the user's forward under no_grad, its backward
    mapped onto the call's positional inputs."""

    @staticmethod
    def forward(ctx, layer_cls, kwargs, *args):
        pctx = PyLayerContext()
        ctx.pctx, ctx.layer_cls = pctx, layer_cls
        ctx.is_tensor = [torch.is_tensor(a) for a in args]
        out = layer_cls.forward(pctx, *args, **kwargs)
        ctx.multi = isinstance(out, (tuple, list))
        return tuple(out) if ctx.multi else out

    @staticmethod
    def backward(ctx, *grads):
        with torch.no_grad():
            gs = ctx.layer_cls.backward(ctx.pctx, *grads)
        gs = list(gs) if isinstance(gs, (tuple, list)) else [gs]
        if len(gs) != len(ctx.is_tensor):
            # Paddle lets backward return gradients of the tensor
            # inputs only
            it = iter(gs)
            gs = [next(it) if t else None for t in ctx.is_tensor]
        return (None, None, *gs)


class PyLayer:
    """A user op with its own backward (``paddle.autograd.PyLayer``)::

        class Exp(PyLayer):
            @staticmethod
            def forward(ctx, x):
                y = torch.exp(x)
                ctx.save_for_backward(y)
                return y

            @staticmethod
            def backward(ctx, dy):
                (y,) = ctx.saved_tensor()
                return dy * y

    ``forward`` runs without recording (its backward replaces
    autodiff for the region); ``backward`` gets one gradient per
    forward output and returns one (or None) per tensor input."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _PyLayerFunction.apply(cls, kwargs, *args)

