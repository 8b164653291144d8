"""Doctor-driven autotune (counterpart of ``paddle_tpu/autotune``): from
a verdict to a knob to the tuning table.

Three tiers behind ``PADDLE_TPU_AUTOTUNE``:

- ``off`` (default): nothing armed;
- ``once``: an offline greedy coordinate-descent pass
  (:class:`~paddle_tpu_torch.autotune.controller.AutotuneController`):
  measure the incumbent, follow the doctor's top verdict to ONE knob
  axis, trial its candidates, accept only a measured improvement beyond
  the noise floor, commit the winner to the tuning table with
  provenance, diagnose again, repeat;
- ``live``: inside a serving engine
  (:class:`~paddle_tpu_torch.autotune.live.LiveRetuner`): an SLO
  regression schedules one episode, which waits for a quiesced engine,
  times the warmed prefill buckets and hot-applies a merged subset (no
  compile); a trainer gets advice only
  (:class:`~paddle_tpu_torch.autotune.live.TrainerRetuner`).

A trial that fails, regresses or compiles inside its measured window is
rolled back to the incumbent and dumped as an ``autotune-rollback``
flight-recorder bundle.
"""
from __future__ import annotations

import os

from .controller import AutotuneController  # noqa: F401
from .knobs import AXES, KnobAxis, axis_for, axis_for_action  # noqa: F401

__all__ = ["AutotuneController", "AXES", "KnobAxis", "axis_for",
           "axis_for_action", "autotune_mode"]


def autotune_mode() -> str:
    """The ``PADDLE_TPU_AUTOTUNE`` tier: 'off' | 'once' | 'live'
    (anything else reads as 'off': a typo must not arm a retuner)."""
    v = os.environ.get("PADDLE_TPU_AUTOTUNE", "").strip().lower()
    return v if v in ("once", "live") else "off"
