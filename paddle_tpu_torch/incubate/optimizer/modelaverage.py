"""ModelAverage: sliding-window parameter averaging for evaluation
(counterpart of ``paddle_tpu/incubate/optimizer/modelaverage.py``, the
accumulator shift rule of Paddle's ``average_accumulates_op.h``):

- every step: ``sum_1 += param``, ``num_updates += 1``,
  ``num_accumulates += 1``;
- every 16384 updates ``sum_1`` folds into ``sum_2`` (no running sum
  grows long);
- when ``num_accumulates >= min_average_window`` and ``num_accumulates
  >= min(max_average_window, num_updates * average_window_rate)`` the
  old window is dropped: ``sum_3 = sum_1 + sum_2``, ``sum_1 = sum_2 =
  0``, ``old_num_accumulates = num_accumulates``, ``num_accumulates =
  0``;
- ``apply()``: ``param <- (sum_1 + sum_2 + sum_3) /
  max(num_accumulates + old_num_accumulates, 1)``.

The three f32 sums and the int32 counters live on the parameters'
device and every choice is a ``torch.where``, so a step reads nothing
back.  ``step()`` accumulates from the parameters themselves, with or
without gradients; in a trainer ``apply_gradients`` does the same and
leaves the parameters as they are.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from ...optimizer.optimizer import Optimizer

__all__ = ["ModelAverage"]

_FOLD_EVERY = 16384  # kMaxNumAccumulates in average_accumulates_op.h


class ModelAverage(Optimizer):
    _accum_names = ("sum_1", "sum_2", "sum_3", "num_accumulates",
                    "old_num_accumulates", "num_updates")

    def __init__(self, average_window_rate: float, parameters=None,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000, name=None):
        super().__init__(learning_rate=0.0, parameters=parameters)
        self.average_window = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        self._restore_values = None

    def _init_accumulators(self, p):
        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=p.device)
        return {"sum_1": zeros(p.shape, torch.float32),
                "sum_2": zeros(p.shape, torch.float32),
                "sum_3": zeros(p.shape, torch.float32),
                "num_accumulates": zeros((), torch.int32),
                "old_num_accumulates": zeros((), torch.int32),
                "num_updates": zeros((), torch.int32)}

    def _update(self, p, g, state, lr, step):
        s1, s2, s3 = state["sum_1"], state["sum_2"], state["sum_3"]
        na, ona, nu = (state["num_accumulates"],
                       state["old_num_accumulates"], state["num_updates"])
        nu.add_(1)
        na.add_(1)
        s1.add_(p.float())
        fold = (nu % _FOLD_EVERY) == 0
        s2.copy_(torch.where(fold, s2 + s1, s2))
        s1.masked_fill_(fold, 0.0)
        window = torch.clamp((nu.float() * self.average_window)
                             .to(torch.int32), max=self.max_average_window)
        shift = (na >= self.min_average_window) & (na >= window)
        s3.copy_(torch.where(shift, s1 + s2, s3))
        s1.masked_fill_(shift, 0.0)
        s2.masked_fill_(shift, 0.0)
        ona.copy_(torch.where(shift, na, ona))
        na.masked_fill_(shift, 0)

    @torch.no_grad()
    def step(self):
        """Accumulate every trainable parameter (gradients or not)."""
        live = {str(i): p for i, p in enumerate(self._parameters or [])
                if p.requires_grad}
        self.init_state(live)
        for n, p in live.items():
            self._update(p, None, self._accumulators[n], 0.0,
                         self._step_count + 1)
        self._step_count += 1

    def _averaged(self, p, accs):
        total = accs["sum_1"] + accs["sum_2"] + accs["sum_3"]
        count = torch.clamp(
            accs["num_accumulates"] + accs["old_num_accumulates"], min=1)
        return (total / count.float()).to(p.dtype)

    @contextmanager
    def apply(self, need_restore: bool = True):
        """Swap the averages into the parameters (in place); they come
        back on exit unless ``need_restore=False``."""
        if self._restore_values is not None:
            raise RuntimeError("ModelAverage.apply() calls cannot nest")
        self._restore_values = {}
        with torch.no_grad():
            for i, p in enumerate(self._parameters or []):
                accs = self._accumulators.get(str(i))
                if accs is None:
                    continue
                self._restore_values[str(i)] = p.detach().clone()
                p.copy_(self._averaged(p, accs))
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self):
        """Put the values from before ``apply()`` back."""
        if self._restore_values is None:
            return
        for i, p in enumerate(self._parameters or []):
            if str(i) in self._restore_values:
                p.copy_(self._restore_values[str(i)])
        self._restore_values = None

    def state_dict(self):
        sd = {f"{pname}@{aname}": t for pname, accs in
              self._accumulators.items() for aname, t in accs.items()}
        sd["@step_count"] = self._step_count
        return sd
