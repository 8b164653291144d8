"""Dtype names and the default float dtype (counterpart of
``paddle_tpu/core/dtype.py``).

Paddle's dtype names map to torch dtypes; ``convert_dtype`` accepts a
name, a torch dtype or a numpy dtype.  The default float dtype is what
``Layer`` parameters and ``to_tensor`` of float64 host data take.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["convert_dtype", "dtype_name", "set_default_dtype",
           "get_default_dtype", "default_float_dtype", "is_floating",
           "is_integer", "bool_", "uint8", "int8", "int16", "int32", "int64",
           "float16", "bfloat16", "float32", "float64", "complex64",
           "complex128"]

_DTYPE_ALIASES = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}
_NAMES = {v: k for k, v in _DTYPE_ALIASES.items()}

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_default_dtype = torch.float32


def convert_dtype(dtype) -> Optional[torch.dtype]:
    """A dtype spec (Paddle name, torch dtype, numpy dtype or None) as a
    torch dtype (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype[len("paddle."):] if dtype.startswith("paddle.") \
            else dtype
        if name not in _DTYPE_ALIASES:
            raise ValueError(f"Unknown dtype {dtype!r}; known: "
                             f"{sorted(_DTYPE_ALIASES)}")
        return _DTYPE_ALIASES[name]
    name = np.dtype(dtype).name
    if name not in _DTYPE_ALIASES:
        raise ValueError(f"dtype {dtype!r} has no torch counterpart")
    return _DTYPE_ALIASES[name]


def dtype_name(dtype) -> str:
    """Paddle's short name of a dtype (``'float32'``, ``'bfloat16'``)."""
    return _NAMES[convert_dtype(dtype)]


def set_default_dtype(dtype):
    """The float dtype of new parameters and of float host data
    (``paddle.set_default_dtype``)."""
    global _default_dtype
    d = convert_dtype(dtype)
    if not d.is_floating_point:
        raise TypeError(f"default dtype must be floating, got {d}")
    _default_dtype = d


def get_default_dtype() -> str:
    return dtype_name(_default_dtype)


def default_float_dtype() -> torch.dtype:
    return _default_dtype


def is_floating(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not d.is_floating_point and not d.is_complex and d != torch.bool
