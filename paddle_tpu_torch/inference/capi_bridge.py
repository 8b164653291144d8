"""Python side of the C inference API (counterpart of
``paddle_tpu/inference/capi_bridge.py``).

The C shim (``capi/pd_inference.c``) embeds CPython and calls three
functions here: ``create`` / ``run`` / ``destroy``, trading in ``(raw
bytes, shape, dtype name)`` triples, so no numpy C API crosses the
boundary.  The predictor is ``jit.load``'s ``TranslatedLayer`` on the
card, or on the device ``PD_INFERENCE_DEVICE`` names (``cpu``), which a
C program sets as a Python one passes ``device="cpu"``.

The training entry (``create_trainer`` / ``trainer_step``) waits for
``SpmdTrainer.export_train_step``: it raises, and the C caller reads the
reason from ``PD_GetLastError``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..jit.api import _to_numpy, load

_predictors: Dict[int, object] = {}
_next_handle = 1


def create(model_path: str) -> int:
    """Load a ``jit.save`` artifact; returns an opaque handle."""
    global _next_handle
    layer = load(model_path, device=os.environ.get("PD_INFERENCE_DEVICE"))
    h = _next_handle
    _next_handle += 1
    _predictors[h] = layer
    return h


def _host(t: torch.Tensor) -> np.ndarray:
    """An output as contiguous host numpy (bf16 as f32)."""
    return np.ascontiguousarray(_to_numpy(t))


def run(handle: int,
        inputs: List[Tuple[bytes, Tuple[int, ...], str]]
        ) -> List[Tuple[bytes, Tuple[int, ...], str]]:
    """inputs / outputs: (raw little-endian bytes, shape, dtype name)."""
    layer = _predictors[handle]
    args = [np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(tuple(shape)).copy()
            for raw, shape, dtype in inputs]
    result = []
    for leaf in pytree.tree_leaves(layer(*args)):
        a = _host(leaf)
        result.append((a.tobytes(), tuple(a.shape), a.dtype.name))
    return result


def destroy(handle: int) -> None:
    _predictors.pop(handle, None)


def checksum(raw: bytes) -> int:
    """``capi_demo``'s checksum of an output's bytes: the sum of its
    32-bit words, word i weighted by i + 1, modulo 2^64."""
    w = np.frombuffer(raw[:len(raw) // 4 * 4], dtype=np.uint32)
    return int((w.astype(np.uint64) *
                np.arange(1, len(w) + 1, dtype=np.uint64)).sum(
                    dtype=np.uint64))


_WAITING = ("the C training entry waits for SpmdTrainer.export_train_step "
            "(ROADMAP Queue 1 item 2): the port does not capture a "
            "backward and update step yet")


def create_trainer(path: str) -> int:
    raise NotImplementedError(_WAITING)


def trainer_step(handle: int, inputs) -> Tuple[bytes, Tuple[int, ...], str]:
    raise NotImplementedError(_WAITING)


def destroy_trainer(handle: int) -> None:
    pass
