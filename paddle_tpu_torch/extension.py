"""Custom-op extension API: register your own kernels as framework ops
(counterpart of ``paddle_tpu/extension.py``).

``register_op(name, forward, backward=...)`` makes an op that
- takes part in autograd with its own backward (a
  ``torch.autograd.Function``), or, without one, differentiates through
  the forward's torch ops;
- is recorded as one node of a static ``Program`` when an argument is a
  static ``Variable``;
- is found again by ``get_op(name)`` / ``list_ops()``.

The backward contract is the JAX package's (PD_BUILD_GRAD_OP): it
receives the forward inputs, the forward outputs and the output
cotangents, and returns one gradient per forward input (None for an
input without one).

``py_func`` runs a host (numpy) function as an op: the custom op
``paddle_tpu::py_func``, whose fake form gives the declared output
shapes, so it is recorded by a static ``Program`` and captured by
``jit.to_static`` like any other op, and calls the host function when
the op runs.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .core.dtype import convert_dtype
from .jit.api import _to_numpy as _to_host

__all__ = ["register_op", "get_op", "list_ops", "CustomOp", "py_func"]

_REGISTRY: Dict[str, "CustomOp"] = {}


def _record(fn, args, kwargs=None):
    """The static Program's record of ``fn(*args)`` when static mode is
    on and an argument is a ``Variable``; else None."""
    from .static import program as _prog
    if not _prog.in_static_mode():
        return None
    return _prog.maybe_record(fn, args, kwargs or {})


def _autograd_function(name: str, forward: Callable, backward: Callable):
    """A ``torch.autograd.Function`` over ``forward`` whose backward is
    ``backward(inputs, outputs, cotangents)``; static config keywords
    come in as the first argument."""

    class Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, kwargs, *args):
            out = forward(*args, **kwargs)
            multi = isinstance(out, (tuple, list))
            outs = tuple(out) if multi else (out,)
            ctx.multi = multi
            ctx.arg_tensor = [torch.is_tensor(a) for a in args]
            ctx.consts = [None if torch.is_tensor(a) else a for a in args]
            ctx.save_for_backward(*[a for a in args if torch.is_tensor(a)],
                                  *outs)
            return tuple(outs) if multi else outs[0]

        @staticmethod
        def backward(ctx, *cots):
            saved = list(ctx.saved_tensors)
            n_in = sum(ctx.arg_tensor)
            tensors, outs = iter(saved[:n_in]), saved[n_in:]
            args = [next(tensors) if t else c
                    for t, c in zip(ctx.arg_tensor, ctx.consts)]
            grads = backward(args, tuple(outs) if ctx.multi else outs[0],
                             tuple(cots) if ctx.multi else cots[0])
            if not isinstance(grads, (tuple, list)):
                grads = (grads,)
            if len(grads) != len(args):
                raise ValueError(
                    f"custom op {name!r}: backward returned "
                    f"{len(grads)} grads for {len(args)} inputs")
            return (None, *grads)

    Op.__name__ = f"CustomOp_{name}"
    return Op


class CustomOp:
    """A registered custom operator (callable)."""

    def __init__(self, name: str, forward: Callable,
                 backward: Optional[Callable] = None):
        self.name = name
        self._forward = forward
        self._backward = backward
        self._fn = None if backward is None else \
            _autograd_function(name, forward, backward)

    def _call(self, *args, **kwargs):
        if self._fn is None:
            return self._forward(*args, **kwargs)
        return self._fn.apply(kwargs, *args)

    def __call__(self, *args, **kwargs):
        rec = _record(functools.partial(self._call, **kwargs), args)
        return rec if rec is not None else self._call(*args, **kwargs)

    @property
    def raw(self) -> Callable:
        """The function the op runs (for use inside other torch code)."""
        return self._call


def register_op(name: str, forward: Optional[Callable] = None,
                backward: Optional[Callable] = None):
    """Register a custom op; usable directly or as a decorator:

        @register_op("fused_swiglu")
        def fused_swiglu(x, w): ...

        op = register_op("my_gelu", my_gelu, backward=gelu_grad)
    """
    def _register(fn):
        if name in _REGISTRY:
            raise ValueError(f"custom op {name!r} already registered")
        op = CustomOp(name, fn, backward)
        _REGISTRY[name] = op
        return op

    if forward is None:
        return _register
    return _register(forward)


def get_op(name: str) -> CustomOp:
    if name not in _REGISTRY:
        raise KeyError(f"no custom op named {name!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_ops():
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# py_func: host functions as the custom op paddle_tpu::py_func
# ---------------------------------------------------------------------------
# key -> (func, backward_func, output templates [(shape, dtype)], multi),
# one key for each distinct entry (an eager loop reuses its key)
_PY_FUNCS: Dict[int, tuple] = {}
_PY_INDEX: Dict[tuple, int] = {}




def _host_outputs(res, templates, device):
    res = res if isinstance(res, (list, tuple)) else (res,)
    return [torch.as_tensor(np.asarray(r).astype(
                np.dtype(str(dt).replace("torch.", ""))).reshape(shape),
                device=device)
            for r, (shape, dt) in zip(res, templates)]


@torch.library.custom_op("paddle_tpu::py_func", mutates_args=())
def _py_func_op(key: int, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    func, _, templates, _ = _PY_FUNCS[key]
    device = xs[0].device if xs else torch.device("cpu")
    return _host_outputs(func(*[_to_host(x) for x in xs]), templates,
                         device)


@_py_func_op.register_fake
def _(key, xs):
    _, _, templates, _ = _PY_FUNCS[key]
    device = xs[0].device if xs else torch.device("cpu")
    return [torch.empty(shape, dtype=dt, device=device)
            for shape, dt in templates]


@torch.library.custom_op("paddle_tpu::py_func_grad", mutates_args=())
def _py_func_grad_op(key: int, xs: List[torch.Tensor],
                     outs: List[torch.Tensor],
                     cots: List[torch.Tensor]) -> List[torch.Tensor]:
    _, backward_func, _, _ = _PY_FUNCS[key]
    g = backward_func([_to_host(x) for x in xs],
                      [_to_host(o) for o in outs],
                      [_to_host(c) for c in cots])
    g = g if isinstance(g, (list, tuple)) else (g,)
    return [torch.zeros_like(x) if gi is None else
            torch.as_tensor(np.asarray(gi), device=x.device).to(
                x.dtype).reshape(x.shape)
            for gi, x in zip(g, xs)]


@_py_func_grad_op.register_fake
def _(key, xs, outs, cots):
    return [torch.empty_like(x) for x in xs]


def _py_setup(ctx, inputs, output):
    key, xs = inputs
    ctx.key = key
    ctx.save_for_backward(*xs, *output)
    ctx.n_in = len(xs)


def _py_backward(ctx, cots):
    saved = ctx.saved_tensors
    xs, outs = list(saved[:ctx.n_in]), list(saved[ctx.n_in:])
    if _PY_FUNCS[ctx.key][1] is None:
        raise RuntimeError("py_func: no backward_func was given, so the op "
                           "has no gradient")
    cots = [torch.zeros_like(o) if c is None else c
            for c, o in zip(cots, outs)]
    return None, _py_func_grad_op(ctx.key, xs, outs, cots)


_py_func_op.register_autograd(_py_backward, setup_context=_py_setup)


def _template(o):
    if torch.is_tensor(o):
        return tuple(o.shape), o.dtype
    shape, dtype = o
    return tuple(int(s) for s in shape), convert_dtype(dtype)


def _is_template(o):
    if torch.is_tensor(o):
        return True
    return (isinstance(o, (tuple, list)) and len(o) == 2 and
            isinstance(o[0], (tuple, list)) and
            (isinstance(o[1], (str, torch.dtype)) or hasattr(o[1], "name")))


def py_func(func, x, out, backward_func=None, name="py_func"):
    """Run a host (numpy) function as an op (Paddle's ``py_func``).

    ``x``: an input tensor or a list; ``out``: output template(s),
    ``(shape, dtype)`` tuples or tensors whose shape and dtype declare
    the result; ``backward_func(inputs, outputs, out_grads)`` returns
    the per-input gradients (numpy), optional.  The host function runs
    when the op runs: eagerly, in ``Executor.run`` and inside a captured
    ``to_static`` program, so it must be pure and keep its shapes."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    multi = isinstance(out, (list, tuple)) and not _is_template(out)
    outs = list(out) if multi else [out]
    entry = (func, backward_func, tuple(_template(o) for o in outs), multi)
    key = _PY_INDEX.get(entry)
    if key is None:
        key = _PY_INDEX[entry] = len(_PY_FUNCS) + 1
        _PY_FUNCS[key] = entry

    def call(*arrs):
        res = _py_func_op(key, list(arrs))
        return tuple(res) if multi else res[0]

    rec = _record(call, xs)
    return rec if rec is not None else call(*xs)
