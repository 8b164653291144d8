"""Dynamic loss scaling for eager training (counterpart of
``paddle_tpu/amp/grad_scaler.py``).

``scale(loss)`` multiplies the loss by the scale before the caller's
``backward()``; ``step(optimizer)`` divides every gradient by it, checks
them for nan/inf (one device reduction, one host read) and runs the
optimizer only when all are finite; ``update()`` moves the scale: up by
``incr_ratio`` after ``incr_every_n_steps`` finite steps in a row, down
by ``decr_ratio`` after ``decr_every_n_nan_or_inf`` bad ones, never
below ``min_loss_scaling``.  ``state_dict`` carries the scale, the
streaks and the lifetime counters.
"""
from __future__ import annotations

import torch

from ..distributed.async_dispatch import record_host_sync

__all__ = ["AmpScaler", "GradScaler"]


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True,
                 min_loss_scaling=1.0):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        # a long non-finite streak halves the scale only down to here
        self._min_scale = float(min_loss_scaling)
        self._use_dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        # lifetime counters (ride state_dict): finite steps, non-finite
        # steps, optimizer updates skipped
        self._total_good_steps = 0
        self._total_bad_steps = 0
        self._skipped_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._use_dynamic

    def get_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def scale(self, loss):
        """The loss times the scale."""
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient by the scale and note whether any is
        non-finite (one host read for all of them)."""
        if not self._enable or self._unscaled:
            return
        inv = 1.0 / self._scale
        bad = None
        for p in optimizer._parameters or []:
            if p.grad is None:
                continue
            p.grad.mul_(inv)
            flag = ~torch.isfinite(p.grad).all()
            bad = flag if bad is None else bad | flag
        self._found_inf = bool(bad) if bad is not None else False
        if bad is not None:
            record_host_sync()
        self._unscaled = True

    def minimize(self, optimizer, loss, *args, **kwargs):
        """``step`` then ``update``; runs ``loss.backward()`` first when no
        parameter has a gradient yet."""
        if not any(p.grad is not None for p in optimizer._parameters or []):
            loss.backward()
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        """Unscale, then step unless a gradient was non-finite."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        else:
            self._skipped_steps += 1
        self._unscaled = False

    def update(self):
        """Move the scale by the outcome of the last step."""
        if not self._enable or not self._use_dynamic:
            self._found_inf = False
            return
        if self._found_inf:
            self._good_steps = 0
            self._bad_steps += 1
            self._total_bad_steps += 1
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio,
                                  self._min_scale)
                self._bad_steps = 0
        else:
            self._bad_steps = 0
            self._good_steps += 1
            self._total_good_steps += 1
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                "min_loss_scaling": self._min_scale,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps,
                "total_good_steps": self._total_good_steps,
                "total_bad_steps": self._total_bad_steps,
                "skipped_steps": self._skipped_steps,
                "use_dynamic_loss_scaling": self._use_dynamic}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._min_scale = sd.get("min_loss_scaling", self._min_scale)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)
        self._total_good_steps = sd.get("total_good_steps", 0)
        self._total_bad_steps = sd.get("total_bad_steps", 0)
        self._skipped_steps = sd.get("skipped_steps", 0)

    set_state_dict = load_state_dict


class GradScaler(AmpScaler):
    """``paddle.amp.GradScaler``."""
