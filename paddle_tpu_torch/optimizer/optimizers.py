"""SGD, Momentum, Adam and AdamW (counterpart of
``paddle_tpu/optimizer/optimizers.py``).

The update rules are the JAX package's formulas, written with in-place
tensor ops.  Adam in particular is not ``torch.optim.Adam``: it folds
both bias corrections into one step size,
``p -= lr * sqrt(1 - b2^t) / (1 - b1^t) * m1 / (sqrt(m2) + eps)``, so
eps sits outside the bias correction; the two drift apart over steps.
Moments are kept in f32, and the bias corrections are computed in f32
as the JAX step computes them (on the device for a device step count).
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW"]


class SGD(Optimizer):
    def _update(self, p, g, state, lr, step):
        p.sub_(lr * g.to(p.dtype))


class Momentum(Optimizer):
    _accum_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _update(self, p, g, state, lr, step):
        v = state["velocity"]
        v.mul_(self._momentum).add_(g)
        if self._use_nesterov:
            p.sub_(lr * (g + self._momentum * v))
        else:
            p.sub_(lr * v)


class Adam(Optimizer):
    _accum_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._step_size_key = self._step_size_val = None

    def _init_accumulators(self, p):
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n in self._accum_names}

    def _step_size(self, lr, step):
        """``lr * sqrt(1 - b2^t) / (1 - b1^t)`` in f32, as the JAX step
        computes it (``1 - b2^t`` loses digits to cancellation in f32, so
        the precision shows in the parameters): on the device for a
        device count, else once per step on the host."""
        if torch.is_tensor(step):
            t = step.float()
        elif self._step_size_key == (lr, step):
            return self._step_size_val
        else:
            t = torch.tensor(float(step))
        bc1 = 1.0 - torch.pow(self._beta1, t)
        bc2 = 1.0 - torch.pow(self._beta2, t)
        size = lr * torch.sqrt(bc2) / bc1
        if torch.is_tensor(step):
            return size
        self._step_size_key, self._step_size_val = (lr, step), size.item()
        return self._step_size_val

    def _update(self, p, g, state, lr, step):
        g32 = g.float()
        m1, m2 = state["moment1"], state["moment2"]
        m1.mul_(self._beta1).add_(g32, alpha=1 - self._beta1)
        m2.mul_(self._beta2).addcmul_(g32, g32, value=1 - self._beta2)
        step_size = self._step_size(lr, step)
        new_p = p.float() - step_size * m1 / (m2.sqrt() + self._epsilon)
        p.copy_(self._extra_decay(new_p, p, lr))

    def _extra_decay(self, new_p, p, lr):
        return new_p


class AdamW(Adam):
    """Adam with decoupled weight decay ``p -= lr * coeff * p`` (from the
    parameter before this step), skipped for parameters whose name
    ``apply_decay_param_fun`` rejects."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None):
        if not isinstance(weight_decay, (int, float)):
            raise TypeError(f"AdamW weight_decay must be a float, got "
                            f"{type(weight_decay)}")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._wd_coeff = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _extra_decay(self, new_p, p, lr):
        fn = self._apply_decay_param_fun
        if fn is not None and self._cur_param_name is not None and \
                not fn(self._cur_param_name):
            return new_p
        return new_p - lr * self._wd_coeff * p.float()
