"""``to_static`` / ``save`` / ``load`` (counterpart of
``paddle_tpu/jit/api.py``).

The JAX package jits the pure function ``(params, buffers, key, args) ->
(outputs, new buffers)`` once per cache key and runs it on the eager
tape.  The port captures the same pure function (``params, buffers,
*args``) with ``torch.export`` once per key and calls the captured
program with the layer's live parameters as inputs, so autograd carries
gradients to them and an optimizer over ``layer.parameters()`` trains
the layer.  Nothing falls back: a capture that fails raises, and only
``enable_to_static(False)`` runs the eager layer.

- The key is ``(training, each input's shape, dtype and device)``, as
  in JAX, plus the ``auto_cast`` state: the port's casts happen inside
  the ops, so a capture holds them.
- Buffers updated in training (batch-norm statistics) come back from
  the program and are written into the layer's buffers.
- Random ops (dropout masks, the attention dropout's Philox pair) are
  ops of the captured graph: every call draws afresh.
- The port's attention kernels (rows 1-3) are ``torch.library`` custom
  ops, so the captured graph calls them; no library attention appears.

``save`` writes ``path + ".pdmodel"`` (the captured inference program,
``torch.export.save``) and ``path + ".pdiparams"`` (a pickle of numpy
``params`` / ``buffers``, the JAX file's names and layout).  A ``None``
dim of an ``InputSpec`` is a dynamic dim.  A JAX ``.pdmodel`` (StableHLO)
is not a program the port can load.
"""
from __future__ import annotations

import functools
import os
import pickle
import threading
from typing import Any, Dict

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..device import current_device, resolve_device
from ..func import functional_call, functional_state

__all__ = ["to_static", "not_to_static", "StaticFunction", "save", "load",
           "TranslatedLayer", "in_tracing", "enable_to_static"]

_tls = threading.local()
_to_static_enabled = True


def enable_to_static(flag: bool):
    """``ProgramTranslator().enable(False)``: with False every
    ``StaticFunction`` runs its eager function."""
    global _to_static_enabled
    _to_static_enabled = bool(flag)


def in_tracing() -> bool:
    return bool(getattr(_tls, "tracing", 0))


def _abstract(tree):
    return tuple((tuple(a.shape), a.dtype, a.device) if torch.is_tensor(a)
                 else a for a in pytree.tree_leaves(tree))


def _amp_key():
    from ..amp.auto_cast import amp_state
    st = amp_state()
    if st is None or not st.enabled:
        return None
    return (st.dtype, st.level, frozenset(st.white), frozenset(st.black))


class _Pure(torch.nn.Module):
    """``(params, buffers, *args) -> (outputs, new buffers)`` of a layer
    (or ``*args -> (outputs, {})`` of a function), the module
    ``torch.export`` captures.  The layer is held outside the module's
    children, so the capture has no state of its own."""

    def __init__(self, layer, fn, training):
        super().__init__()
        self.__dict__["_target"] = (layer, fn)
        self.training_flag = training

    def forward(self, params, buffers, *args, **kwargs):
        layer, fn = self._target
        _tls.tracing = getattr(_tls, "tracing", 0) + 1
        try:
            if layer is not None and fn is None:
                return functional_call(layer, params, buffers, *args,
                                       training=self.training_flag,
                                       **kwargs)
            return fn(*args, **kwargs), {}
        finally:
            _tls.tracing -= 1


def _capture(module, args, kwargs=None, dynamic_shapes=None):
    try:
        return torch.export.export(module, tuple(args), kwargs or None,
                                   dynamic_shapes=dynamic_shapes)
    except Exception as e:
        raise RuntimeError(
            f"to_static: capturing the forward with torch.export failed "
            f"({type(e).__name__}: {e}); enable_to_static(False) runs the "
            f"eager layer") from e


class StaticFunction:
    """A layer (or function) with its cache of captured programs, one per
    key (Paddle's ``StaticFunction`` and its program cache)."""

    def __init__(self, function, input_spec=None, build_strategy=None,
                 property=False):
        if isinstance(function, torch.nn.Module):
            self._layer = function
            self._fn = function.forward
        else:
            self._layer = getattr(function, "__self__", None)
            self._fn = function
        # a layer's forward: captured with its tensors as inputs; any other
        # function or method: captured as it is
        self._whole = isinstance(self._layer, torch.nn.Module) and \
            self._fn == self._layer.forward
        self._input_spec = input_spec
        self._cache: Dict[Any, Any] = {}
        self.captures = 0
        functools.update_wrapper(self, self._fn)

    def __call__(self, *args, **kwargs):
        layer, whole = self._layer, self._whole
        if not _to_static_enabled:
            return layer(*args, **kwargs) if whole else \
                self._fn(*args, **kwargs)
        training = layer.training if whole else False
        params, buffers = functional_state(layer) if whole else ({}, {})
        key = (training, _abstract((args, kwargs)), _amp_key())
        program = self._cache.get(key)
        if program is None:
            pure = _Pure(layer if whole else None,
                         None if whole else self._fn, training)
            ep = _capture(pure, (params, buffers, *args), kwargs)
            program = self._cache[key] = ep.module()
            self.captures += 1
        out, new_buffers = program(params, buffers, *args, **kwargs)
        if new_buffers:
            with torch.no_grad():
                for name, t in new_buffers.items():
                    buffers[name].copy_(t)
        return out

    @property
    def code(self):
        import inspect
        return inspect.getsource(self._fn)

    def concrete_program(self, *args):
        """The JAX package returns None here; so does the port."""
        return None


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """``@paddle.jit.to_static``."""
    def decorate(fn):
        return StaticFunction(fn, input_spec=input_spec,
                              build_strategy=build_strategy)
    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    fn._not_to_static = True
    return fn


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------
def _dynamic():
    return getattr(torch.export.Dim, "DYNAMIC", None) or \
        torch.export.Dim("batch", min=1)


def _example(spec, device):
    """An input for the capture and its dynamic dims: an ``InputSpec``'s
    ``None`` dims take 2 (a 1 would make the capture specialize)."""
    from ..core.dtype import convert_dtype
    if torch.is_tensor(spec):
        return spec.to(device), None
    shape = [2 if s in (None, -1) else int(s) for s in spec.shape]
    dtype = convert_dtype(getattr(spec, "dtype", None)) or torch.float32
    dyn = {i: _dynamic() for i, s in enumerate(spec.shape)
           if s in (None, -1)}
    return torch.zeros(shape, dtype=dtype, device=device), dyn or None


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; bf16 goes to f32 (numpy has no bf16), which ``load``
    casts back to the dtype the program takes."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def save(layer, path, input_spec=None, **configs):
    """``paddle.jit.save``: the layer's inference program (eval mode,
    under the ``auto_cast`` state of the call) and its weights."""
    if isinstance(layer, StaticFunction):
        layer = layer._layer
    if not isinstance(layer, torch.nn.Module):
        raise TypeError("jit.save expects a Layer or its to_static wrapper")
    if input_spec is None:
        raise ValueError(
            "jit.save needs input_spec=[InputSpec(shape, dtype), ...] or "
            "example tensors to capture the program")
    params, buffers = functional_state(layer)
    ref = next(iter(params.values()), None)
    device = ref.device if ref is not None else current_device()
    examples, dyn = zip(*[_example(s, device) for s in input_spec])
    # forward(params, buffers, *args): the varargs take one tuple of specs
    dynamic_shapes = ({k: None for k in params}, {k: None for k in buffers},
                      tuple(dyn))
    was_training = layer.training
    layer.eval()
    try:
        with torch.no_grad():
            ep = _capture(_Pure(layer, None, False),
                          ({k: v.detach() for k, v in params.items()},
                           buffers, *examples),
                          dynamic_shapes=dynamic_shapes)
    finally:
        layer.train(was_training)
    # the program alone: its example inputs would hold every weight again
    ep.example_inputs = None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".pdmodel", "wb") as f:
        torch.export.save(ep, f)
    state = {"params": {k: _to_numpy(v) for k, v in params.items()},
             "buffers": {k: _to_numpy(v) for k, v in buffers.items()}}
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump(state, f, protocol=4)


def _program_device(ep) -> torch.device:
    for n in ep.graph.nodes:
        val = n.meta.get("val") if n.op == "placeholder" else None
        if torch.is_tensor(val):
            return val.device
    return torch.device("cpu")


def _move_program(ep, device: torch.device):
    """``ep`` with its tensors and device arguments on ``device``."""
    if _program_device(ep).type == device.type:
        return ep
    from torch.export.passes import move_to_device_pass
    return move_to_device_pass(ep, device)


class TranslatedLayer(torch.nn.Module):
    """The layer ``jit.load`` returns: the loaded program with the loaded
    weights, on one device, for inference."""

    def __init__(self, exported, params, buffers, device=None):
        super().__init__()
        self._device = resolve_device(device)
        self._exported = _move_program(exported, self._device)
        self._program = self._exported.module()
        # the dtype each weight takes in the program, in input order
        user = set(self._exported.graph_signature.user_inputs)
        dtypes = iter(n.meta["val"].dtype for n in self._exported.graph.nodes
                      if n.op == "placeholder" and n.name in user)

        def load(arr):
            return torch.as_tensor(np.asarray(arr)).to(
                self._device, next(dtypes))

        self._params = {k: load(v) for k, v in params.items()}
        self._buffers_in = {k: load(v) for k, v in buffers.items()}

    def forward(self, *args):
        args = [torch.as_tensor(np.asarray(a)) if not torch.is_tensor(a)
                else a for a in args]
        args = [a.to(self._device) for a in args]
        with torch.no_grad():
            out, _ = self._program(self._params, self._buffers_in, *args)
        return out


def load(path, device=None, **configs):
    """``paddle.jit.load``: a ``TranslatedLayer`` on the card unless
    ``device="cpu"``."""
    device = resolve_device(device)
    with open(path + ".pdmodel", "rb") as f:
        exported = torch.export.load(f)
    with open(path + ".pdiparams", "rb") as f:
        state = pickle.load(f)
    return TranslatedLayer(exported, state["params"], state["buffers"],
                           device)
