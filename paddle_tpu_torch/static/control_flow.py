"""Control-flow ops (counterpart of ``paddle_tpu/static/control_flow.py``):
``cond``, ``while_loop``, ``case``, ``switch_case``.

On concrete tensors they run plain Python, as Paddle's dygraph does.
On static ``Variable`` predicates (``enable_static``) and inside a
capture (``jit.to_static``, ``jit.save``) the branch ops cannot wait
for a value on the host:
- ``cond`` / ``case`` / ``switch_case`` run every branch and select the
  taken one's outputs elementwise (``torch.where``), so the branches
  must return matching structures, shapes and dtypes (the rule of
  Paddle's static mode and of ``lax.cond``) and be free of side
  effects;
- ``while_loop`` on Variables records one node that runs the loop when
  the program runs (its body may read captured tensors, not other
  Variables); inside a capture it is torch's ``while_loop`` operator.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import compiler
from torch.utils import _pytree as pytree

__all__ = ["cond", "while_loop", "case", "switch_case"]


def _symbolic(*xs) -> bool:
    """Whether a value cannot be read on the host: a static Variable, or
    a tensor inside a capture."""
    from .program import Variable
    leaves = pytree.tree_leaves(list(xs))
    if any(isinstance(x, Variable) for x in leaves):
        return True
    return compiler.is_compiling() and \
        any(torch.is_tensor(x) for x in leaves)


def _select(pred, a, b):
    """``a`` where the scalar ``pred`` holds, else ``b``, leaf by leaf."""
    p = torch.as_tensor(pred).reshape(()).to(torch.bool)
    la, spec = pytree.tree_flatten(a)
    lb, spec_b = pytree.tree_flatten(b)
    if spec != spec_b:
        raise ValueError(f"cond: the branches return different structures: "
                         f"{spec} and {spec_b}")
    return pytree.tree_unflatten([torch.where(p, x, y)
                                  for x, y in zip(la, lb)], spec)


def cond(pred, true_fn: Callable = None, false_fn: Callable = None,
         name=None, return_names=None):
    """Paddle's ``cond``: ``true_fn()`` if ``pred`` else ``false_fn()``."""
    if not _symbolic(pred):
        return true_fn() if bool(pred) else false_fn()
    return _select(pred, true_fn(), false_fn())


def _eager_loop(cond_fn, body_fn, loop_vars):
    while bool(cond_fn(*loop_vars)):
        out = body_fn(*loop_vars)
        loop_vars = list(out) if isinstance(out, (list, tuple)) else [out]
    return loop_vars


def while_loop(cond_fn: Callable, body_fn: Callable, loop_vars,
               is_test=False, name=None):
    """Paddle's ``while_loop``: the body keeps each loop variable's shape
    and dtype."""
    from .program import Variable, maybe_record
    loop_vars = list(loop_vars)
    if any(isinstance(v, Variable) for v in loop_vars):
        metas = tuple(v._meta if isinstance(v, Variable) else
                      torch.as_tensor(v).to("meta") for v in loop_vars)

        def loop(*vals):
            return tuple(_eager_loop(cond_fn, body_fn, list(vals)))

        return list(maybe_record(loop, loop_vars, out_meta=metas,
                                 force=True))
    if not _symbolic(loop_vars):
        return _eager_loop(cond_fn, body_fn, loop_vars)
    from torch._higher_order_ops.while_loop import while_loop as _hop

    def c(*vs):
        return torch.as_tensor(cond_fn(*vs)).reshape(()).to(torch.bool)

    def b(*vs):
        out = body_fn(*vs)
        return tuple(out) if isinstance(out, (list, tuple)) else (out,)

    return list(_hop(c, b, tuple(loop_vars)))


def case(pred_fn_pairs: Sequence[Tuple], default: Optional[Callable] = None,
         name=None):
    """Paddle's ``case``: the first true predicate's function (the last
    function when none holds and no ``default`` is given)."""
    if not pred_fn_pairs:
        raise ValueError("pred_fn_pairs must not be empty")
    preds = [p for p, _ in pred_fn_pairs]
    fns = [f for _, f in pred_fn_pairs]
    if default is None:
        default = fns[-1]
    if not _symbolic(preds):
        for p, f in pred_fn_pairs:
            if bool(p):
                return f()
        return default()
    out = default()
    for p, f in reversed(pred_fn_pairs):
        out = _select(p, f(), out)
    return out


def switch_case(branch_index, branch_fns, default: Optional[Callable] = None,
                name=None):
    """Paddle's ``switch_case``: the branch keyed by ``branch_index``; with
    ``default=None`` the last branch is the default, eagerly and
    symbolically alike."""
    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items())
    else:
        items = list(enumerate(branch_fns)) \
            if not isinstance(branch_fns[0], (tuple, list)) \
            else sorted((int(k), v) for k, v in branch_fns)
    if default is None:
        default = items[-1][1]
    if not _symbolic(branch_index):
        i = int(branch_index)
        for k, f in items:
            if k == i:
                return f()
        return default()
    out = default()
    for k, f in reversed(items):
        out = _select(branch_index == k, f(), out)
    return out
