"""``paddle.static`` (counterpart of ``paddle_tpu/static/__init__.py``):
``InputSpec`` for capture signatures, ``data``, the Program / Executor
workflow (``program``), control flow, the ``helpers`` surface, and the
layer helpers of ``static.nn`` (imported on first use)."""
from __future__ import annotations

from ..core.dtype import convert_dtype
from ..device import CPUPlace, CUDAPlace
from .control_flow import case, cond, switch_case, while_loop  # noqa: F401
from .program import (  # noqa: F401
    Executor, InferenceProgram, Program, Variable, default_main_program,
    default_startup_program, disable_static, enable_static,
    in_static_mode, load_inference_model, program_guard,
    save_inference_model)
from .helpers import *  # noqa: F401,F403,E402
from .helpers import __all__ as _helpers_all
from ..extension import py_func  # noqa: F401,E402
from .. import amp  # noqa: F401,E402  (paddle.static.amp)


def __getattr__(name):
    # static.nn imports the functional layers: loaded on first use, as
    # the JAX package does
    if name == "nn":
        import importlib
        mod = importlib.import_module(".nn", __name__)
        globals()["nn"] = mod
        return mod
    raise AttributeError(f"module 'paddle_tpu_torch.static' has no "
                         f"attribute {name!r}")


__all__ = ["InputSpec", "data", "cond", "while_loop", "case",
           "switch_case", "nn", "Executor", "Program", "Variable",
           "program_guard", "default_main_program",
           "default_startup_program", "enable_static", "disable_static",
           "in_static_mode", "save_inference_model",
           "load_inference_model", "InferenceProgram", "py_func",
           "amp", "CPUPlace", "CUDAPlace"] + list(_helpers_all)


class InputSpec:
    """Paddle's ``InputSpec``: a shape (``None`` for a dynamic dim), a
    dtype and a name."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = tuple(shape)
        self.dtype = convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tuple(tensor.shape), tensor.dtype, name)

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(ndarray.shape, ndarray.dtype, name)

    def batch(self, batch_size):
        return InputSpec((batch_size,) + self.shape, self.dtype, self.name)

    def unbatch(self):
        return InputSpec(self.shape[1:], self.dtype, self.name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


def data(name, shape, dtype="float32", lod_level=0):
    """``paddle.static.data``: in static mode a graph input of the
    default Program; otherwise an ``InputSpec``."""
    if in_static_mode():
        from .program import record_data
        return record_data(name, shape, convert_dtype(dtype))
    return InputSpec(shape, dtype, name)
