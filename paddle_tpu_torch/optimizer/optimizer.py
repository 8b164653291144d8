"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

Every optimizer defines one update rule, ``_update(p, g, state, lr,
step)``, used two ways as in the JAX package:
- eagerly by ``step()`` over the ``parameters`` it was built with and
  their ``.grad`` (accumulators keyed by the parameter's position);
- by the trainer through ``apply_gradients(params, grads)`` over dicts
  keyed by structured parameter name.

Both apply, in the JAX order, gradient clipping, then coupled L2 decay
(``weight_decay`` as a float: ``g + coeff * p``), then the update.
Unlike JAX, which returns new arrays, the port updates each parameter
and its accumulators IN PLACE (no second copy of the optimizer state
during a step); the new value is cast back to the parameter's dtype.
Learning rate and bias corrections are Python floats, so a step reads
nothing back from the device.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .lr import LRScheduler

__all__ = ["Optimizer"]


class Optimizer:
    _accum_names: Sequence[str] = ()
    # AdamW decays the parameter itself instead of the gradient
    _decoupled_wd = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        self._lr = learning_rate
        self._parameters = list(parameters) if parameters is not None \
            else None
        self._grad_clip = grad_clip
        if weight_decay is not None and \
                not isinstance(weight_decay, (int, float)):
            raise TypeError(f"weight_decay must be a float (coupled L2 "
                            f"coefficient), got {type(weight_decay)}")
        self._weight_decay = None if weight_decay is None \
            else float(weight_decay)
        self._accumulators: Dict[str, Dict[str, torch.Tensor]] = {}
        self._step_count = 0
        # the name of the parameter being updated (AdamW's
        # apply_decay_param_fun reads it)
        self._cur_param_name: Optional[str] = None
        self._lr_scheduler = self._lr if isinstance(
            self._lr, LRScheduler) else None

    # ---- learning rate -----------------------------------------------
    def get_lr(self) -> float:
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler())
        return float(self._lr)

    def set_lr(self, value: float):
        if self._lr_scheduler is not None:
            raise RuntimeError(
                "cannot set_lr when using an LRScheduler; call "
                "scheduler.step() instead")
        self._lr = float(value)

    # ---- update rule (override) --------------------------------------
    def _init_accumulators(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: torch.zeros_like(p) for name in self._accum_names}

    def _update(self, p: torch.Tensor, g: torch.Tensor,
                state: Dict[str, torch.Tensor], lr: float, step: int):
        """Update ``p`` and ``state`` in place."""
        raise NotImplementedError

    # ---- both paths ----------------------------------------------------
    @torch.no_grad()
    def apply_gradients(self, params: Dict[str, torch.Tensor],
                        grads: Dict[str, torch.Tensor],
                        lr: Optional[float] = None,
                        step: Optional[int] = None) -> None:
        """Clip, decay, update: every ``params[n]`` in place from
        ``grads[n]``; accumulators live on the optimizer by name."""
        lr = self.get_lr() if lr is None else float(lr)
        step = (self._step_count + 1) if step is None else int(step)
        if self._grad_clip is not None:
            grads = self._grad_clip.clip_arrays(grads)
        if self._weight_decay is not None and not self._decoupled_wd:
            grads = {n: g + self._weight_decay * params[n]
                     for n, g in grads.items()}
        for n, p in params.items():
            state = self._accumulators.get(n)
            if state is None:
                state = self._accumulators[n] = self._init_accumulators(p)
            self._cur_param_name = n
            self._update(p, grads[n], state, lr, step)

    def step(self):
        """Eager update of the parameters given at construction from
        their ``.grad`` (parameters without a gradient are skipped)."""
        if self._parameters is None:
            raise ValueError("optimizer constructed without parameters; "
                             "pass parameters=model.parameters() for "
                             "eager use")
        live = {str(i): p for i, p in enumerate(self._parameters)
                if p.grad is not None and p.requires_grad}
        self.apply_gradients(live, {n: p.grad for n, p in live.items()},
                             step=self._step_count + 1)
        self._step_count += 1

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameters or []:
            if p.grad is not None and set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    # ---- state dict ------------------------------------------------------
    def state_dict(self):
        sd = {f"{pname}@{aname}": t for pname, accs in
              self._accumulators.items() for aname, t in accs.items()}
        if self._lr_scheduler is not None:
            sd["LR_Scheduler"] = self._lr_scheduler.state_dict()
        sd["@step"] = self._step_count
        return sd

    def set_state_dict(self, state_dict):
        self._step_count = int(state_dict.get("@step", 0))
        if self._lr_scheduler is not None and "LR_Scheduler" in state_dict:
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])
        for key, val in state_dict.items():
            if key in ("LR_Scheduler", "@step") or "@" not in key:
                continue
            pname, aname = key.rsplit("@", 1)
            self._accumulators.setdefault(pname, {})[aname] = val
