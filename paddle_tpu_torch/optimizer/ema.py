"""Exponential moving average of parameters (counterpart of
``paddle_tpu/optimizer/ema.py``): ``EMA_t = d * EMA_{t-1} + (1 - d) *
p_t`` in f32, bias-corrected when read by ``1 / (1 - prod(d))``, with the
optional ``thres_steps`` schedule ``d_t = min(decay, (1 + t) / (10 + t))``.

Two forms, as in the JAX package:
- functional, for a trainer's masters: ``init_state(params)``,
  ``update_state(params, state)`` and ``averaged(params, state)`` over
  dicts of tensors.  The state (shadows, the decay product, the step
  ``t``) lives on the parameters' device and is updated in place, so an
  update reads nothing back;
- eager: ``update()``, ``apply()`` (a context manager) and ``restore()``
  over the ``parameters`` given at construction, keyed by their position
  as the port's optimizers key them.
State-dict keys are ``name@ema``, ``name@decay_prod`` and ``@t``.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["ExponentialMovingAverage"]


class ExponentialMovingAverage:
    def __init__(self, decay: float = 0.999, thres_steps: bool = False,
                 parameters=None, name=None):
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay must be in [0, 1), got {decay}")
        self._decay = float(decay)
        # True: the schedule runs on the EMA's own update count
        self._thres_steps = bool(thres_steps)
        self._parameters = list(parameters) if parameters is not None \
            else None
        self._shadow: Dict[str, torch.Tensor] = {}
        self._decay_prod: Dict[str, torch.Tensor] = {}
        self._t = 0
        self._restore_values: Optional[dict] = None

    def _current_decay(self, t):
        """``(d, 1 - d)`` of this update, f32 values as in the JAX
        package: device scalars for a device step ``t`` (the schedule
        computed in f32 there), else host floats that f32 represents
        exactly (a host step's schedule in double, then rounded, as the
        JAX eager form does).  No host-to-device copy either way."""
        if self._thres_steps and torch.is_tensor(t):
            tf = t.float()
            d = torch.clamp((1.0 + tf) / (10.0 + tf), max=self._decay)
            return d, 1.0 - d
        d = np.float32(self._decay)
        if self._thres_steps:
            d = min(d, np.float32((1.0 + t) / (10.0 + t)))
        return float(d), float(np.float32(1.0) - d)

    # ---- functional form (a trainer's masters) -------------------------
    def init_state(self, params: Dict[str, torch.Tensor]) -> dict:
        """``{'shadow': f32 zeros like each parameter, 'decay_prod': 1.0,
        't': 0}`` on the parameters' device."""
        dev = next(iter(params.values())).device
        return {"shadow": {n: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                           for n, p in params.items()},
                "decay_prod": torch.ones((), dtype=torch.float32,
                                         device=dev),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update_state(self, params: Dict[str, torch.Tensor],
                     state: dict) -> dict:
        """One EMA step over ``params``, in place on ``state``; returns
        it."""
        state["t"].add_(1)
        d, rest = self._current_decay(state["t"])
        for n, s in state["shadow"].items():
            s.copy_(d * s + rest * params[n].float())
        state["decay_prod"].mul_(d)
        return state

    @torch.no_grad()
    def averaged(self, params: Dict[str, torch.Tensor],
                 state: dict) -> Dict[str, torch.Tensor]:
        """The bias-corrected averages ``shadow / (1 - prod(decay))`` in
        each parameter's dtype."""
        corr = torch.clamp(1.0 - state["decay_prod"], min=1e-12)
        return {n: (s / corr).to(params[n].dtype)
                for n, s in state["shadow"].items()}

    # ---- eager form ----------------------------------------------------
    def _named(self):
        if self._parameters is None:
            raise RuntimeError(
                "ExponentialMovingAverage constructed without parameters; "
                "pass parameters=model.parameters() for eager use")
        return {str(i): p for i, p in enumerate(self._parameters)}

    @torch.no_grad()
    def update(self):
        self._t += 1
        d, rest = self._current_decay(self._t)
        for n, p in self._named().items():
            s = self._shadow.get(n)
            if s is None:
                s = self._shadow[n] = torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device)
                self._decay_prod[n] = torch.ones(
                    (), dtype=torch.float32, device=p.device)
            s.copy_(d * s + rest * p.float())
            self._decay_prod[n].mul_(d)

    @contextmanager
    def apply(self, need_restore: bool = True):
        """Swap the bias-corrected averages into the parameters (in
        place); they come back on exit unless ``need_restore=False``."""
        if self._restore_values is not None:
            raise RuntimeError("EMA.apply() calls cannot nest")
        self._restore_values = {}
        with torch.no_grad():
            for n, p in self._named().items():
                s = self._shadow.get(n)
                if s is None:
                    continue
                self._restore_values[n] = p.detach().clone()
                corr = torch.clamp(1.0 - self._decay_prod[n], min=1e-12)
                p.copy_((s / corr).to(p.dtype))
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self):
        if self._restore_values is None:
            return
        for n, p in self._named().items():
            if n in self._restore_values:
                p.copy_(self._restore_values[n])
        self._restore_values = None

    def state_dict(self):
        sd = {f"{n}@ema": s for n, s in self._shadow.items()}
        sd.update({f"{n}@decay_prod": d for n, d in self._decay_prod.items()})
        sd["@t"] = self._t
        return sd

    def set_state_dict(self, sd):
        self._t = int(sd.get("@t", 0))
        for key, val in sd.items():
            if key == "@t":
                continue
            name, kind = key.rsplit("@", 1)
            if kind == "ema":
                self._shadow[name] = val
            elif kind == "decay_prod":
                self._decay_prod[name] = val
