"""Automatic mixed precision (counterpart of ``paddle_tpu/amp``): the
eager dynamic loss scaler.  ``SpmdTrainer`` runs the same state machine
on the device under fp16 AMP (``strategy.amp_configs``); the per-op
casting of ``auto_cast`` is not ported (ROADMAP.md)."""
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["AmpScaler", "GradScaler"]
