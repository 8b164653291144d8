"""``paddle.save`` / ``paddle.load`` (counterpart of
``paddle_tpu/framework/io.py``), for local paths.

The file is the JAX package's: a pickle of the (nested) object with each
tensor replaced by ``{"__paddle_tpu_tensor__": True, "data": ndarray,
"name", "stop_gradient", "is_param"}``, so a ``.pdparams`` written by
either package loads in the other.  bf16 tensors travel as
``ml_dtypes.bfloat16`` arrays (the JAX package's numpy form), which
needs ``ml_dtypes`` installed.  ``load`` puts tensors on the current
device (``device.set_device``), or returns the arrays with
``return_numpy=True``.  Both go through ``framework.fs``: an
``hdfs://`` or ``afs://`` path through the hadoop CLI, a local path
written atomically (fsync, then rename).
"""
from __future__ import annotations

import pickle
from typing import Any

import numpy as np
import torch

from ..core.tensor import Parameter, from_numpy
from ..device import current_device

__all__ = ["save", "load"]

_SENTINEL_KEY = "__paddle_tpu_tensor__"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _pack(obj: Any):
    if torch.is_tensor(obj):
        return {_SENTINEL_KEY: True, "data": _to_numpy(obj),
                "name": getattr(obj, "name", None),
                "stop_gradient": not obj.requires_grad,
                "is_param": isinstance(obj, torch.nn.Parameter)}
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        return type(obj)(packed) if type(obj) in (list, tuple) else packed
    return obj


def _unpack(obj: Any, return_numpy: bool, device):
    if isinstance(obj, dict):
        if obj.get(_SENTINEL_KEY):
            if return_numpy:
                return obj["data"]
            t = from_numpy(obj["data"]).to(device)
            if obj.get("is_param"):
                return Parameter(t, name=obj.get("name"))
            return t.requires_grad_(not obj.get("stop_gradient", True)) \
                if t.is_floating_point() else t
        return {k: _unpack(v, return_numpy, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        un = [_unpack(v, return_numpy, device) for v in obj]
        return type(obj)(un) if type(obj) in (list, tuple) else un
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` (a state dict, nested containers, a tensor) in the
    JAX package's format."""
    from .fs import open_for_write
    with open_for_write(str(path), "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """Read what ``save`` (of either package) wrote."""
    from .fs import open_for_read
    with open_for_read(str(path), "rb") as f:
        obj = pickle.load(f)
    device = None if return_numpy else current_device()
    return _unpack(obj, return_numpy, device)
