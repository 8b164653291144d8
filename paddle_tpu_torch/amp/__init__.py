"""Automatic mixed precision (counterpart of ``paddle_tpu/amp``): the
eager dynamic loss scaler and ``auto_cast``'s per-op casting in the
layer API's functionals.  ``SpmdTrainer`` runs the same state machine on
the device under fp16 AMP (``strategy.amp_configs``)."""
from .auto_cast import (amp_guard, amp_state, auto_cast, black_list,
                        decorate, white_list)
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["AmpScaler", "GradScaler", "auto_cast", "amp_guard",
           "amp_state", "white_list", "black_list", "decorate"]
