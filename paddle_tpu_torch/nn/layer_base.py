"""``Layer``: Paddle's module base on ``torch.nn.Module`` (counterpart of
``paddle_tpu/nn/layer_base.py``).

A ``Layer`` is a ``torch.nn.Module`` with Paddle's API on top:
``create_parameter`` / ``add_parameter`` / ``add_sublayer``;
``parameters()`` as a list, ``named_parameters``, ``sublayers``,
``named_sublayers``; ``state_dict`` / ``set_state_dict`` under the JAX
package's structured names (``encoder.layers.0.linear1.weight``);
``train`` / ``eval``; forward pre and post hooks returning a
``HookRemoveHelper``; ``to(device, dtype)``; ``full_name``.  Torch's
own calls (``Module.state_dict(prefix=...)``, ``named_parameters(
recurse=...)``, ``torch.func.functional_call``) keep working, so a
``Layer`` sits inside a plain ``nn.Module`` and the other way round.

Parameters are ``core.tensor.Parameter``s drawn on the layer's device
(the current device unless the layer was built with ``device=``) from
that device's layer-API generator (``core.random.get_generator``), or
from the ``generator=`` a layer was built with.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.dtype import convert_dtype, default_float_dtype
from ..core import random as prandom
from ..core.tensor import Parameter, from_numpy
from ..device import current_device, resolve_device
from . import initializer as I

__all__ = ["Layer", "ParamAttr", "HookRemoveHelper"]

# per-prefix counters (linear_0, layernorm_0, linear_1), as in the JAX
# package
_layer_name_counters: Dict[str, int] = {}
# the name prefix utils.unique_name.guard("ns_") sets
_layer_name_prefix: str = ""


class ParamAttr:
    """Parameter attributes: name, initializer, learning-rate scale,
    regularizer, trainable, need_clip."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if attr is False:
            return False
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"Cannot make ParamAttr from {type(attr)}")


class HookRemoveHelper:
    """The handle of a forward hook: ``remove()`` takes it out."""

    def __init__(self, handle):
        self._handle = handle

    def remove(self):
        self._handle.remove()


def _to_value(value) -> torch.Tensor:
    """A state-dict entry (tensor, numpy array, ml_dtypes bf16 array) as
    a tensor."""
    return value.detach() if torch.is_tensor(value) else from_numpy(value)


class Layer(torch.nn.Module):
    """Base class of every layer (Paddle's ``paddle.nn.Layer``)."""

    def __init__(self, name_scope: Optional[str] = None, dtype=None):
        super().__init__()
        self._dtype = convert_dtype(dtype) or default_float_dtype()
        if name_scope is None:
            prefix = _layer_name_prefix + self.__class__.__name__.lower()
            idx = _layer_name_counters.get(prefix, 0)
            _layer_name_counters[prefix] = idx + 1
            name_scope = f"{prefix}_{idx}"
        self._full_name = name_scope
        self._param_index = {"w": 0, "b": 0}
        # where create_parameter draws: None is the current device and
        # its layer-API generator
        self._device = None
        self._generator = None

    # ---- construction ------------------------------------------------
    def _placement(self, device=None, generator=None):
        """Pin this layer's parameters to ``device`` / ``generator``
        (the layers' optional keywords)."""
        self._device = None if device is None else resolve_device(device)
        self._generator = generator

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> Optional[Parameter]:
        """A new parameter of ``shape``: ``attr`` (a ParamAttr, a name, an
        initializer, or False for none) over ``default_initializer``,
        then the global initializer, then XavierUniform (weights) or
        zeros (biases)."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = convert_dtype(dtype) or self._dtype
        init = attr.initializer or default_initializer
        if init is None:
            gw, gb = I.get_global_initializer()
            init = (gb or I.Constant(0.0)) if is_bias \
                else (gw or I.XavierUniform())
        device = self._device if self._device is not None \
            else current_device()
        generator = self._generator if self._generator is not None \
            else prandom.get_generator(device)
        data = torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                           device=device)
        with torch.no_grad():
            init(data, generator)
        name = attr.name
        if name is None:
            kind = "b" if is_bias else "w"
            name = f"{self._full_name}.{kind}_{self._param_index[kind]}"
            self._param_index[kind] += 1
        p = Parameter(data, name=name, trainable=attr.trainable)
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def create_tensor(self, name=None, persistable=None, dtype=None):
        device = self._device if self._device is not None \
            else current_device()
        return torch.zeros((), dtype=convert_dtype(dtype) or self._dtype,
                           device=device)

    def add_parameter(self, name: str, parameter):
        if parameter is not None and \
                not isinstance(parameter, torch.nn.Parameter):
            raise TypeError("add_parameter expects a Parameter or None")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        if sublayer is not None and \
                not isinstance(sublayer, torch.nn.Module):
            raise TypeError("add_sublayer expects a Layer or None")
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        *, persistent: Optional[bool] = None):
        super().register_buffer(
            name, tensor,
            persistent=persistable if persistent is None else persistent)

    # ---- traversal ---------------------------------------------------
    def parameters(self, include_sublayers: bool = True, *,
                   recurse: Optional[bool] = None) -> List[Parameter]:
        recurse = include_sublayers if recurse is None else recurse
        return [p for _, p in super().named_parameters(recurse=recurse)]

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True,
                         remove_duplicate: bool = True, *,
                         recurse: Optional[bool] = None
                         ) -> Iterator[Tuple[str, Parameter]]:
        recurse = include_sublayers if recurse is None else recurse
        return super().named_parameters(prefix=prefix, recurse=recurse,
                                        remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers: bool = True, *,
                recurse: Optional[bool] = None) -> List[torch.Tensor]:
        recurse = include_sublayers if recurse is None else recurse
        return list(super().buffers(recurse=recurse))

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True,
                      remove_duplicate: bool = True, *,
                      recurse: Optional[bool] = None):
        recurse = include_sublayers if recurse is None else recurse
        return super().named_buffers(prefix=prefix, recurse=recurse,
                                     remove_duplicate=remove_duplicate)

    def sublayers(self, include_self: bool = False) -> List[torch.nn.Module]:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False,
                        layers_set=None):
        for name, m in self.named_modules(prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    # ---- hooks -------------------------------------------------------
    def register_forward_pre_hook(self, hook, *, prepend=False,
                                  with_kwargs=False) -> HookRemoveHelper:
        """``hook(layer, inputs)`` before forward; a non-None return
        replaces the inputs."""
        return HookRemoveHelper(super().register_forward_pre_hook(
            hook, prepend=prepend, with_kwargs=with_kwargs))

    def register_forward_post_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs, outputs)`` after forward; a non-None
        return replaces the outputs."""
        return HookRemoveHelper(self.register_forward_hook(hook))

    # ---- state dict --------------------------------------------------
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True,
                   *args, prefix: Optional[str] = None,
                   keep_vars: Optional[bool] = None):
        """The parameters and persistable buffers by structured name
        (the live tensors).  Called the way ``torch.nn.Module`` calls
        its children (``prefix=``, ``keep_vars=``), it is torch's."""
        if prefix is not None or keep_vars is not None or args:
            return super().state_dict(*args, destination=destination,
                                      prefix=prefix or "",
                                      keep_vars=bool(keep_vars))
        dest = destination if destination is not None \
            else collections.OrderedDict()
        head = structured_name_prefix.rstrip(".")
        for name, p in self.named_parameters(
                prefix=head, include_sublayers=include_sublayers):
            dest[name] = p
        mods = self.named_modules(prefix=head) if include_sublayers \
            else [(head, self)]
        for name, layer in mods:
            for bname, b in layer._buffers.items():
                if b is None or bname in layer._non_persistent_buffers_set:
                    continue
                dest[f"{name}.{bname}" if name else bname] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name: bool = True,
                       *, strict: bool = True):
        """Copy ``state_dict`` (tensors or numpy arrays, e.g. the JAX
        package's ``state_dict()`` as numpy) into this layer's
        parameters and buffers, cast to each one's dtype and device.
        A missing or unknown name or a shape mismatch raises; with
        ``strict=False`` they are skipped.  Returns ``(missing,
        unexpected)``."""
        own = self.state_dict()
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        mismatched = [k for k in own if k in state_dict and
                      tuple(_to_value(state_dict[k]).shape)
                      != tuple(own[k].shape)]
        if strict and (missing or unexpected or mismatched):
            raise ValueError(
                f"set_state_dict: missing {missing}, unexpected "
                f"{unexpected}, shape mismatch {[(k, tuple(own[k].shape)) for k in mismatched]}")
        with torch.no_grad():
            for key, target in own.items():
                if key in missing or key in mismatched:
                    continue
                target.copy_(_to_value(state_dict[key]).to(
                    device=target.device, dtype=target.dtype))
        return missing, unexpected

    load_dict = set_state_dict

    # ---- dtype / device ----------------------------------------------
    def to(self, device=None, dtype=None, blocking=None, *args, **kwargs):
        """``to(device=None, dtype=None)`` (Paddle) or any of torch's
        forms; a dtype casts the floating parameters and buffers.  The
        parameter objects stay the same."""
        if args or kwargs or isinstance(device, torch.Tensor):
            return super().to(*((device,) if device is not None else ()),
                              *((dtype,) if dtype is not None else ()),
                              *args, **kwargs)
        if isinstance(device, (torch.dtype, np.dtype)) or (
                isinstance(device, str) and not device.split(":")[0] in
                ("cpu", "gpu", "cuda")):
            device, dtype = None, device
        d = convert_dtype(dtype)
        dev = None if device is None else resolve_device(device)
        if d is not None:
            for m in self.modules():
                if isinstance(m, Layer):
                    m._dtype = d
        return super().to(device=dev, dtype=d)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def full_name(self) -> str:
        return self._full_name

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError
