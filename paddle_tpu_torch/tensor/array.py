"""TensorArray ops (counterpart of ``paddle_tpu/tensor/array.py``): the
LoDTensorArray role as a plain Python list of tensors."""
from __future__ import annotations

import torch

from ..device import current_device
from ._util import tensor as _t

__all__ = ["TensorArray", "create_array", "array_write", "array_read",
           "array_length"]


class TensorArray(list):
    """A list of tensors."""

    def __init__(self, dtype="float32"):
        super().__init__()
        self.dtype = dtype


def create_array(dtype="float32", initialized_list=None):
    arr = TensorArray(dtype)
    for v in (initialized_list or ()):
        arr.append(_t(v))
    return arr


def _idx(i):
    return int(i.item()) if torch.is_tensor(i) else int(i)


def array_write(x, i, array=None):
    """``x`` at index ``i``, which may extend the array by one slot; the
    array is returned."""
    if array is None:
        array = create_array(getattr(x, "dtype", "float32"))
    i = _idx(i)
    x = _t(x)
    if i < len(array):
        array[i] = x
    elif i == len(array):
        array.append(x)
    else:
        raise IndexError(
            f"array_write index {i} skips slots (len={len(array)})")
    return array


def array_read(array, i):
    i = _idx(i)
    if not 0 <= i < len(array):
        raise IndexError(f"array_read index {i} out of range "
                         f"(len={len(array)})")
    return array[i]


def array_length(array):
    dev = array[0].device if len(array) else current_device()
    return torch.full((), len(array), dtype=torch.int64, device=dev)
