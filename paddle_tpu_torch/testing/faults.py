"""Deterministic fault injection (counterpart of part of
``paddle_tpu/testing/faults.py``).

PADDLE_FAULT_NAN_STEP="k"
    ``SpmdTrainer`` fills every floating gradient with NaN on train
    step k (1-indexed).  Read when the trainer is built.
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["nan_poison_step"]


def nan_poison_step() -> Optional[int]:
    """The step (1-indexed) whose gradients ``SpmdTrainer`` poisons with
    NaN, or None when ``PADDLE_FAULT_NAN_STEP`` is unset or not an
    integer."""
    v = os.environ.get("PADDLE_FAULT_NAN_STEP")
    if not v:
        return None
    try:
        return int(v)
    except ValueError:
        return None
