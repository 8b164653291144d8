"""LookAhead optimizer (counterpart of
``paddle_tpu/incubate/optimizer/lookahead.py``): k steps of the inner
optimizer forward, then the slow weights catch up, ``slow += alpha *
(fast - slow)``, and the fast weights restart from them.

The rule is part of ``_update``, so it runs in the eager ``step()`` and
inside ``SpmdTrainer`` alike; the slow copy is one more accumulator (a
real copy of the parameter, never an alias).  With a device step count
the ``step % k`` choice is a ``torch.where`` on the device.
"""
from __future__ import annotations

import torch

from ...optimizer.optimizer import Optimizer

__all__ = ["LookAhead"]


class LookAhead(Optimizer):
    def __init__(self, inner_optimizer: Optimizer, alpha: float = 0.5,
                 k: int = 5, name=None):
        if not isinstance(inner_optimizer, Optimizer):
            raise TypeError(
                "inner_optimizer must be a paddle_tpu_torch Optimizer, got "
                f"{type(inner_optimizer).__name__}")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        if k < 1:
            raise ValueError(f"k must be a positive integer, got {k}")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        # the inner optimizer's rate, clip and decay apply at this level
        # (clip and coupled decay run before _update; the inner _update is
        # called bare, so nothing applies twice)
        super().__init__(learning_rate=inner_optimizer._lr,
                         parameters=inner_optimizer._parameters,
                         weight_decay=None,
                         grad_clip=inner_optimizer._grad_clip)
        self._weight_decay = inner_optimizer._weight_decay
        self._lr_scheduler = inner_optimizer._lr_scheduler

    @property
    def _decoupled_wd(self):
        return self.inner_optimizer._decoupled_wd

    def _init_accumulators(self, p):
        accs = self.inner_optimizer._init_accumulators(p)
        if "slow" in accs:
            raise RuntimeError(
                "inner optimizer already has a 'slow' accumulator")
        accs["slow"] = p.detach().clone()
        return accs

    def _update(self, p, g, state, lr, step):
        inner = self.inner_optimizer
        # per-parameter hooks (AdamW's apply_decay_param_fun, Lamb's
        # exclude_from_weight_decay_fn) see the same parameter
        inner._cur_param_name = self._cur_param_name
        inner._cur_param = self._cur_param
        inner._update(p, g, {n: a for n, a in state.items() if n != "slow"},
                      lr, step)
        slow = state["slow"]
        caught_up = slow + self.alpha * (p.to(slow.dtype) - slow)
        if torch.is_tensor(step):
            sync = (step % self.k) == 0
            slow.copy_(torch.where(sync, caught_up, slow))
            p.copy_(torch.where(sync, caught_up.to(p.dtype), p))
        elif step % self.k == 0:
            slow.copy_(caught_up)
            p.copy_(caught_up)

    def get_lr(self):
        return self.inner_optimizer.get_lr()
