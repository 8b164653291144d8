"""SGD, Momentum, Adagrad, RMSProp, Adadelta, Adam, AdamW, Adamax, Lamb
and Lars (counterpart of ``paddle_tpu/optimizer/optimizers.py``).

The update rules are the JAX package's formulas, written with in-place
tensor ops.  Adam in particular is not ``torch.optim.Adam``: it folds
both bias corrections into one step size,
``p -= lr * sqrt(1 - b2^t) / (1 - b1^t) * m1 / (sqrt(m2) + eps)``, so
eps sits outside the bias correction; the two drift apart over steps.
Moments are kept in f32, and the bias corrections are computed in f32
as the JAX step computes them (on the device for a device step count).
Adamax and Lamb take ``beta ** step`` the same way: a Python float for
a host step, ``torch.pow`` on the device for a device one; Lamb's trust
ratio and Lars's local rate choose with ``torch.where``, so no update
reads anything back.  Lamb keeps f32 moments as Adam does; the other
rules keep their accumulators in the parameter's dtype, as JAX does.
Lamb and Lars keep f64 parameters (a reference's copies) in f64.
"""
from __future__ import annotations

import types

import torch
from torch.linalg import vector_norm

from ..regularizer import L2Decay
from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adagrad", "RMSProp", "Adadelta", "Adam",
           "AdamW", "Adamax", "Lamb", "Lars"]


def _wide(t):
    """``t`` in f32, or as it is when it is wider (f64 copies keep
    their precision)."""
    return t if t.dtype == torch.float64 else t.float()


def _bias_correction(beta: float, step):
    """``1 - beta ** step``: a Python float for a host step, an f32
    device scalar for a device step."""
    if torch.is_tensor(step):
        return 1.0 - torch.pow(beta, step.float())
    return 1.0 - beta ** step


class SGD(Optimizer):
    def _update(self, p, g, state, lr, step):
        p.sub_(lr * g.to(p.dtype))

    def _update_sparse(self, p, g, state, lr, step):
        """The touched rows only (untouched rows have a zero gradient, so
        the result is the dense rule's); merge's padding adds zeros."""
        rows, vals = g.in_range()
        p.index_add_(0, rows, (-lr * vals).to(p.dtype))


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


class Adagrad(Optimizer):
    _accum_names = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_val = initial_accumulator_value

    def _init_accumulators(self, p):
        return {"moment": torch.full_like(p, self._init_val)}

    def _update(self, p, g, state, lr, step):
        m = state["moment"]
        m.add_(g * g)
        p.sub_(lr * g / (m.sqrt() + self._epsilon))


class RMSProp(Optimizer):
    """Optionally centered (the mean gradient's square subtracted)."""

    _accum_names = ("mean_square", "mean_grad", "momentum")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _update(self, p, g, state, lr, step):
        rho = self._rho
        ms, mg, mom = state["mean_square"], state["mean_grad"], \
            state["momentum"]
        ms.mul_(rho).add_((1 - rho) * g * g)
        if self._centered:
            mg.mul_(rho).add_((1 - rho) * g)
            denom = (ms - mg * mg + self._epsilon).sqrt()
        else:
            denom = (ms + self._epsilon).sqrt()
        mom.mul_(self._momentum).add_(lr * g / denom)
        p.sub_(mom)


class Adadelta(Optimizer):
    _accum_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._rho = rho

    def _update(self, p, g, state, lr, step):
        rho, eps = self._rho, self._epsilon
        asg, asu = state["avg_squared_grad"], state["avg_squared_update"]
        asg.mul_(rho).add_((1 - rho) * g * g)
        upd = g * (asu + eps).sqrt() / (asg + eps).sqrt()
        asu.mul_(rho).add_((1 - rho) * upd * upd)
        p.sub_(lr * upd)


class Adam(Optimizer):
    """``lazy_mode``: a row-sparse gradient updates only its rows, their
    moments included (untouched rows and moments stay as they are, an
    O(rows x dim) step); without it the dense rule runs on the densified
    gradient (moments decay everywhere)."""

    _accum_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lazy_mode = bool(lazy_mode)
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

    def _update_sparse(self, p, g, state, lr, step):
        if not self._lazy_mode:
            self._update(p, g.to_dense(), state, lr, step)
            return
        # merge's padding slots (row out of range) repeat the first row
        # and its gradient: they compute and write that row's own new
        # values, so every write is well defined and nothing reads the
        # host for the count of real rows
        ok = g.rows < p.shape[0]
        rows = torch.where(ok, g.rows, g.rows[:1])
        gv = torch.where(ok.reshape((-1,) + (1,) * (g.values.dim() - 1)),
                         g.values, g.values[:1]).float()
        m1, m2 = state["moment1"], state["moment2"]
        m1r = self._beta1 * m1[rows] + (1 - self._beta1) * gv
        m2r = self._beta2 * m2[rows] + (1 - self._beta2) * gv * gv
        step_size = self._step_size(lr, step)
        old = p[rows]
        pr = old.float() - step_size * m1r / (m2r.sqrt() + self._epsilon)
        pr = self._extra_decay(pr, old, lr)  # AdamW: rows decay lazily
        p.index_put_((rows,), pr.to(p.dtype))
        m1.index_put_((rows,), m1r)
        m2.index_put_((rows,), m2r)


class AdamW(Adam):
    """Adam with decoupled weight decay ``p -= lr * coeff * p`` (from the
    parameter before this step), skipped for parameters whose name
    ``apply_decay_param_fun`` rejects."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False):
        # decoupled decay is L2-shaped: an L2Decay gives its coefficient
        if isinstance(weight_decay, L2Decay):
            weight_decay = weight_decay.coeff
        if not isinstance(weight_decay, (int, float)):
            raise TypeError(f"AdamW weight_decay must be a float or an "
                            f"L2Decay, got {type(weight_decay)}")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode=lazy_mode)
        self._wd_coeff = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _extra_decay(self, new_p, p, lr):
        fn = self._apply_decay_param_fun
        if fn is not None and self._cur_param_name is not None and \
                not fn(self._cur_param_name):
            return new_p
        return new_p - lr * self._wd_coeff * p.float()


class Adamax(Optimizer):
    _accum_names = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _update(self, p, g, state, lr, step):
        m, inf = state["moment"], state["inf_norm"]
        m.mul_(self._beta1).add_((1 - self._beta1) * g)
        torch.maximum(inf * self._beta2, g.abs(), out=inf)
        lr_t = lr / _bias_correction(self._beta1, step)
        p.sub_(lr_t * m / (inf + self._epsilon))


class Lamb(Optimizer):
    """Layer-adaptive Adam: the Adam direction plus decoupled decay,
    scaled by the trust ratio ``|p| / |r|`` (1 where either norm is 0).
    ``exclude_from_weight_decay_fn(param)`` gets an object carrying
    ``.name`` in both paths: the eager parameter if its ``name`` is a
    string, else a namespace holding the parameter's key (its position
    in the eager path, its structured name in the trainer's)."""

    _accum_names = ("moment1", "moment2")
    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._wd = lamb_weight_decay
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_accumulators(self, p):
        return {n: torch.zeros_like(_wide(p)) for n in self._accum_names}

    def _weight_decay_of(self) -> float:
        if self._exclude_fn is None:
            return self._wd
        target = self._cur_param
        if not isinstance(getattr(target, "name", None), str):
            target = types.SimpleNamespace(name=self._cur_param_name)
        return 0.0 if self._exclude_fn(target) else self._wd

    def _update(self, p, g, state, lr, step):
        b1, b2 = self._beta1, self._beta2
        g32, p32 = _wide(g), _wide(p)
        m1, m2 = state["moment1"], state["moment2"]
        m1.mul_(b1).add_((1 - b1) * g32)
        m2.mul_(b2).add_((1 - b2) * g32 * g32)
        m1_hat = m1 / _bias_correction(b1, step)
        m2_hat = m2 / _bias_correction(b2, step)
        r = m1_hat / (m2_hat.sqrt() + self._epsilon) + \
            self._weight_decay_of() * p32
        p_norm, r_norm = vector_norm(p32), vector_norm(r)
        trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                            1.0)
        p.copy_(p32 - lr * trust * r)


class Lars(Optimizer):
    """LARS momentum: the local rate ``coeff * |p| / (|g| + wd * |p|)``
    (1 where either norm is 0) scales each layer's step."""

    _accum_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._wd = lars_weight_decay

    def _update(self, p, g, state, lr, step):
        p_norm, g_norm = vector_norm(_wide(p)), vector_norm(_wide(g))
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            self._lars_coeff * p_norm / (g_norm + self._wd * p_norm + 1e-12),
            1.0)
        v = state["velocity"]
        v.mul_(self._momentum).add_(lr * local_lr * (g + self._wd * p))
        p.sub_(v)
