"""Python side of the C inference API (counterpart of
``paddle_tpu/inference/capi_bridge.py``).

The C shim (``capi/pd_inference.c``) embeds CPython and calls three
functions here: ``create`` / ``run`` / ``destroy``, trading in ``(raw
bytes, shape, dtype name)`` triples, so no numpy C API crosses the
boundary.  The predictor is ``jit.load``'s ``TranslatedLayer`` on the
card, or on the device ``PD_INFERENCE_DEVICE`` names (``cpu``), which a
C program sets as a Python one passes ``device="cpu"``.

The training entry (``create_trainer`` / ``trainer_step`` /
``destroy_trainer``, behind ``PD_NewTrainer`` / ``PD_TrainerStep``)
steps the program ``SpmdTrainer.export_train_step`` wrote: ``path +
".pdtrain"`` over the state in ``path + ".pdtrainstate"``, on the card
unless ``device`` (or ``PD_INFERENCE_DEVICE``) names the CPU.  Each step
feeds the state the last one returned, at the saved learning rate and
the next step number, and hands back the loss.  A failure raises, and
the C caller reads the reason from ``PD_GetLastError``.
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


_trainers: Dict[int, dict] = {}


def create_trainer(path: str, device=None) -> int:
    """Load an ``export_train_step`` artifact; returns an opaque
    handle."""
    global _next_handle
    import pickle
    from ..device import resolve_device
    from ..jit.api import _move_program, input_dtypes
    device = resolve_device(device if device is not None
                            else os.environ.get("PD_INFERENCE_DEVICE"))
    with open(path + ".pdtrain", "rb") as f:
        exported = _move_program(torch.export.load(f), device)
    with open(path + ".pdtrainstate", "rb") as f:
        state = pickle.load(f)
    dtypes = input_dtypes(exported)

    def load(tree):
        return {k: load(v) if isinstance(v, dict) else
                torch.as_tensor(np.asarray(v)).to(device, next(dtypes))
                for k, v in tree.items()}

    # input order: params, opt_state, buffers (then lr, step, batch)
    params = load(state["params"])
    opt_state = load(state["opt_state"])
    buffers = load(state["buffers"])
    h = _next_handle
    _next_handle += 1
    _trainers[h] = {
        "program": exported.module(), "device": device, "params": params,
        "opt_state": opt_state, "buffers": buffers,
        "lr": torch.tensor(float(state["lr"]), dtype=torch.float32,
                           device=device),
        "step": int(state["step_count"])}
    return h


def trainer_step(handle: int,
                 inputs: List[Tuple[bytes, Tuple[int, ...], str]]
                 ) -> Tuple[bytes, Tuple[int, ...], str]:
    """One step of the exported program on ``inputs`` (the batch as
    ``(bytes, shape, dtype name)`` triples); returns the loss triple."""
    t = _trainers[handle]
    dev = t["device"]
    batch = [torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dt))
                              .reshape(tuple(shape)).copy()).to(dev)
             for raw, shape, dt in inputs]
    step = torch.tensor(t["step"] + 1, dtype=torch.int32, device=dev)
    with torch.no_grad():
        t["params"], t["opt_state"], t["buffers"], loss = t["program"](
            t["params"], t["opt_state"], t["buffers"], t["lr"], step,
            *batch)
    t["step"] += 1
    a = _to_numpy(loss)     # a 0-d array (_host would make it 1-d)
    return (a.tobytes(), tuple(a.shape), a.dtype.name)


def destroy_trainer(handle: int) -> None:
    _trainers.pop(handle, None)
