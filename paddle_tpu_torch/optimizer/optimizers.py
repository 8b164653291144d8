"""SGD, Momentum, Adam and AdamW (counterpart of
``paddle_tpu/optimizer/optimizers.py``).

The update rules are the JAX package's formulas, written with in-place
tensor ops.  Adam in particular is not ``torch.optim.Adam``: it folds
both bias corrections into one step size,
``p -= lr * sqrt(1 - b2^t) / (1 - b1^t) * m1 / (sqrt(m2) + eps)``, so
eps sits outside the bias correction; the two drift apart over steps.
Moments are kept in f32.
"""
from __future__ import annotations

import math

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

    def _init_accumulators(self, p):
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n in self._accum_names}

    def _update(self, p, g, state, lr, step):
        g32 = g.float()
        m1, m2 = state["moment1"], state["moment2"]
        m1.mul_(self._beta1).add_(g32, alpha=1 - self._beta1)
        m2.mul_(self._beta2).addcmul_(g32, g32, value=1 - self._beta2)
        bc1 = 1.0 - self._beta1 ** step
        bc2 = 1.0 - self._beta2 ** step
        step_size = lr * math.sqrt(bc2) / bc1
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
