"""Device resolution and the current device (counterpart of
``paddle_tpu/device.py``).

The port runs on the card unless the caller asks for the CPU: ``None``
means CUDA, and with no CUDA device that raises instead of quietly
running on the CPU.  The layer API (``nn.Layer`` parameters,
``to_tensor``, ``DataLoader`` batches, ``load``) places its tensors on
the current device: the card until ``set_device("cpu")`` is called.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "same_device", "set_device", "get_device",
           "current_device", "is_compiled_with_cuda", "device_count",
           "Place", "CPUPlace", "CUDAPlace"]

# set by set_device; None: the current CUDA device
_current: Optional[torch.device] = None


class Place:
    """Paddle's place objects: a device type and index."""

    def __init__(self, device_type: str, device_id: int = 0):
        self.device_type = device_type
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device(self.device_type, self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Place) and
                (self.device_type, self.device_id) ==
                (other.device_type, other.device_id))

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"


class CPUPlace(Place):
    def __init__(self):
        super().__init__("cpu", 0)


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("cuda", device_id)


def _parse(device) -> torch.device:
    """Paddle's place strings ('gpu', 'gpu:1', 'cpu', 'cuda:0'), a place
    object or a torch device."""
    if isinstance(device, Place):
        return device.torch_device()
    if isinstance(device, str):
        kind, _, idx = device.partition(":")
        if kind == "gpu":
            kind = "cuda"
        return torch.device(f"{kind}:{idx}" if idx else kind)
    return torch.device(device)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> the current CUDA device; raises when CUDA is absent.
    An explicit ``"cpu"`` (what the CPU tests pass) gives the CPU."""
    dev = torch.device("cuda") if device is None else _parse(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: paddle_tpu_torch runs on the GPU unless "
                "device='cpu' is passed explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """Equality that treats ``cuda`` and ``cuda:<current>`` as one."""
    def norm(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return norm(a) == norm(b)


def set_device(device: str) -> torch.device:
    """The layer API's device (``paddle.set_device``): ``'gpu'``,
    ``'gpu:N'`` or ``'cpu'``; a GPU without CUDA raises."""
    global _current
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _current = dev
    return dev


def current_device() -> torch.device:
    """The device of the layer API: the one ``set_device`` chose, else
    the current CUDA device (raises without one)."""
    return _current if _current is not None else resolve_device(None)


def get_device() -> str:
    """``'gpu:N'`` or ``'cpu'`` (``paddle.get_device``)."""
    dev = current_device()
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def device_count() -> int:
    return torch.cuda.device_count()
