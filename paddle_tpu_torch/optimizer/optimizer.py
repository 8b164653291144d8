"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

Every optimizer defines one update rule, ``_update(p, g, state, lr,
step)``, used two ways as in the JAX package:
- eagerly by ``step()`` over the ``parameters`` it was built with and
  their ``.grad`` (accumulators keyed by the parameter's position);
- by the trainer through ``apply_gradients(params, grads)`` over dicts
  keyed by structured parameter name.

Both apply, in the JAX order, gradient clipping, then coupled decay
(``weight_decay``: an ``L1Decay`` / ``L2Decay`` regularizer, a float
meaning ``L2Decay``; in the eager path a parameter's own
``regularizer`` attribute overrides it), then the update.
Unlike JAX, which returns new arrays, the port updates each parameter
and its accumulators IN PLACE (no second copy of the optimizer state
during a step); the new value is cast back to the parameter's dtype.
Each parameter's update runs at the learning rate times its own scale,
``optimize_attr["learning_rate"]`` (``nn.ParamAttr(learning_rate=...)``),
as in the JAX package.

A row-sparse gradient (the sparse COO ``.grad`` of
``Embedding(sparse=True)``) takes the sparse branch of ``step()``: it is
merged (``SelectedRows.merge``) and handed to ``_update_sparse``, which
SGD and Adam / AdamW implement; any other rule raises, and so do
gradient clipping and coupled weight decay with a sparse gradient, as
in the JAX package.

The learning rate is a Python float and the step count a Python int or
an int32 device tensor (the trainer's under fp16 AMP and the ``skip``
anomaly policy, which does not advance on a skipped step), so a step
reads nothing back from the device.

``apply_gradients(..., skip=bad)`` with a device bool scalar keeps each
parameter and its accumulators as they were where ``bad`` is set: one
parameter at a time, its old values are copied aside, the update runs
in place, and ``torch.where(bad, old, new)`` writes the result over
it (the JAX trainer's select, at the cost of one parameter's copies
instead of a second optimizer state).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

from ..regularizer import L2Decay, WeightDecayRegularizer
from .lr import LRScheduler

__all__ = ["Optimizer"]


def _lr_scale(p) -> float:
    """A parameter's own learning-rate scale (``ParamAttr(learning_rate=
    ...)``, kept in ``optimize_attr``); 1 for a plain tensor."""
    attr = getattr(p, "optimize_attr", None)
    return float(attr.get("learning_rate", 1.0)) if attr else 1.0


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
        if isinstance(weight_decay, (int, float)):
            weight_decay = L2Decay(weight_decay)
        elif weight_decay is not None and \
                not isinstance(weight_decay, WeightDecayRegularizer):
            raise TypeError(f"weight_decay must be a float or an L1Decay / "
                            f"L2Decay, got {type(weight_decay)}")
        self._weight_decay = weight_decay
        self._accumulators: Dict[str, Dict[str, torch.Tensor]] = {}
        self._step_count = 0
        # the name and, in the eager path, the object of the parameter
        # being updated (AdamW's apply_decay_param_fun and Lamb's
        # exclude_from_weight_decay_fn read them)
        self._cur_param_name: Optional[str] = None
        self._cur_param = None
        # the eager parameters by name while step() runs
        self._param_objs: Dict[str, torch.Tensor] = {}
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
                state: Dict[str, torch.Tensor], lr: float,
                step: Union[int, torch.Tensor]):
        """Update ``p`` and ``state`` in place."""
        raise NotImplementedError

    def _update_sparse(self, p: torch.Tensor, g, state, lr: float, step):
        """Update ``p`` and ``state`` in place from ``g``, a merged
        ``SelectedRows``.  Only SGD and Adam implement it."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support sparse "
            f"(SelectedRows) gradients; use SGD or Adam, or construct "
            f"the Embedding with sparse=False")

    def init_state(self, params: Dict[str, torch.Tensor]) -> None:
        """Create the accumulators of every ``params[n]`` not yet
        tracked (the trainer does so when it is built, so a checkpoint
        can be restored before the first step)."""
        for n, p in params.items():
            if n not in self._accumulators:
                self._accumulators[n] = self._init_accumulators(p)

    # ---- both paths ----------------------------------------------------
    @torch.no_grad()
    def apply_gradients(self, params: Dict[str, torch.Tensor],
                        grads: Dict[str, torch.Tensor],
                        lr: Union[float, torch.Tensor, None] = None,
                        step: Union[int, torch.Tensor, None] = None,
                        skip: Optional[torch.Tensor] = None,
                        states: Optional[Dict[str, Dict[str, torch.Tensor]]]
                        = None) -> None:
        """Clip, decay, update: every ``params[n]`` in place from
        ``grads[n]``; accumulators live on the optimizer by name, or in
        ``states[n]`` when given (also updated in place: an exported
        train step passes its own).  ``lr`` may be a device scalar.
        ``skip``: a device bool scalar; where it is set every parameter
        and accumulator keeps its old value."""
        if lr is None:
            lr = self.get_lr()
        elif not torch.is_tensor(lr):
            lr = float(lr)
        if step is None:
            step = self._step_count + 1
        elif not torch.is_tensor(step):
            step = int(step)
        if self._grad_clip is not None:
            grads = self._grad_clip.clip_arrays(grads)
        if not self._decoupled_wd:
            grads = {n: self._decay(n, params[n], g)
                     for n, g in grads.items()}
        if states is None:
            self.init_state(params)
            states = self._accumulators
        for n, p in params.items():
            state = states[n]
            self._cur_param_name = n
            self._cur_param = self._param_objs.get(n)
            plr = lr * _lr_scale(p)
            if skip is None:
                self._update(p, grads[n], state, plr, step)
                continue
            live = [p, *state.values()]
            old = [t.clone() for t in live]
            self._update(p, grads[n], state, plr, step)
            for t, o in zip(live, old):
                torch.where(skip, o, t, out=t)

    def _decay(self, name, p, g):
        """Coupled decay of ``g``: the eager parameter's own
        ``regularizer`` if it has one, else the optimizer's."""
        reg = getattr(self._param_objs.get(name), "regularizer", None) \
            or self._weight_decay
        return g if reg is None else reg.apply(p, g)

    def step(self):
        """Eager update of the parameters given at construction from
        their ``.grad`` (parameters without a gradient are skipped)."""
        if self._parameters is None:
            raise ValueError("optimizer constructed without parameters; "
                             "pass parameters=model.parameters() for "
                             "eager use")
        self._step_live({str(i): p for i, p in enumerate(self._parameters)
                         if p.grad is not None and p.requires_grad})

    def _step_live(self, live: Dict[str, torch.Tensor]):
        """One update of the named parameters from their ``.grad``."""
        sparse = {n: p for n, p in live.items() if p.grad.is_sparse}
        if sparse and self._grad_clip is not None:
            raise NotImplementedError(
                "grad_clip with sparse (SelectedRows) gradients is not "
                "supported; clip needs the dense grad")
        if not self._decoupled_wd and any(
                (getattr(p, "regularizer", None) or self._weight_decay)
                is not None for p in sparse.values()):
            raise NotImplementedError(
                "coupled weight decay with sparse gradients is not "
                "supported (the decay term is dense)")
        dense = {n: p for n, p in live.items() if n not in sparse}
        self._param_objs = live
        try:
            self.apply_gradients(dense, {n: p.grad for n, p in dense.items()},
                                 step=self._step_count + 1)
            self._step_sparse(sparse, self._step_count + 1)
        finally:
            self._param_objs = {}
            self._cur_param = None
        self._step_count += 1

    def _step_static(self, params, grads):
        """A static program's update (``Executor.run`` after
        ``minimize``): ``grads`` from ``torch.autograd.grad``, one per
        parameter (None: the loss does not read it); accumulators by
        parameter name, as the JAX static step keys them."""
        live = {}
        for p, g in zip(params, grads):
            if g is not None:
                p.grad = g
                live[p.name] = p
        try:
            self._step_live(live)
        finally:
            for p in live.values():
                p.grad = None

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Paddle's ``minimize``.  Dygraph: the gradients are collected,
        not recomputed (``loss.backward(); opt.minimize(loss)`` runs one
        backward): a backward runs here only when no backward wrote this
        optimizer's gradients since its last ``minimize``.  Static: a
        Variable loss installs the training hook on the Program that
        recorded it, and ``Executor.run`` then runs the step."""
        from ..static.program import (Variable, default_main_program,
                                      install_minimize)
        if isinstance(loss, Variable):
            install_minimize(loss.program or default_main_program(),
                             loss, self)
            return None, []
        params = [p for p in (parameters or self._parameters or [])
                  if p.requires_grad]
        if all(p.grad is None for p in params) or \
                self._grad_stamp(params) == getattr(self, "_seen_stamp",
                                                    None):
            loss.backward()
        self.step()
        self._seen_stamp = self._grad_stamp(params)
        return None, [(p, p.grad) for p in params]

    @staticmethod
    def _grad_stamp(params):
        """Which gradient tensors, at which versions, the parameters hold:
        unchanged since the last minimize means no backward wrote them."""
        return tuple((id(p.grad), p.grad._version) if p.grad is not None
                     else None for p in params)

    @torch.no_grad()
    def _step_sparse(self, params: Dict[str, torch.Tensor], step: int):
        from ..core.selected_rows import SelectedRows
        lr = self.get_lr()
        self.init_state(params)
        for n, p in params.items():
            self._cur_param_name, self._cur_param = n, p
            g = SelectedRows.from_sparse(p.grad).merge()
            self._update_sparse(p, g, self._accumulators[n],
                                lr * _lr_scale(p), step)

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
