"""Activation recompute (counterpart of
``paddle_tpu/distributed/recompute.py``).

``recompute(fn, *args, policy=None)`` runs ``fn`` without keeping its
inner activations; the backward runs its forward again
(``torch.utils.checkpoint``, non-reentrant).  ``policy`` names what the
region keeps instead of recomputing, as the JAX package's
``jax.checkpoint_policies`` do:

- ``None`` / ``'full'`` / ``'nothing'``: keep nothing (full recompute);
- ``'dots'``: keep the outputs of the matrix products ``aten.mm``,
  ``aten.addmm``, ``aten.bmm`` and ``aten.baddbmm``;
- ``'dots_no_batch'``: keep only the unbatched ones, ``mm`` and
  ``addmm`` (the block linears; the CPU's plain attention products are
  batched);
- ``'everything'``: keep every op's output.  Keeping every residual is
  running without recompute (under ``jax.checkpoint`` too, XLA then keeps
  only the residuals the backward reads), so ``recompute`` calls the
  function plainly.

The two dots policies run as ``torch.utils.checkpoint``'s
``create_selective_checkpoint_contexts``, which sees aten ops only.  A
hand-written kernel (the flash attention forward) is a ctypes launch
into a buffer from ``torch.empty``: it is no aten op, so the backward's
re-run launches it again, as JAX recomputes a ``pallas_call`` under
``checkpoint_dots``.

An auxiliary loss (a MoE router's) made inside the region is collected
there and returned as one of the region's outputs, then handed to the
caller's open collector (``distributed.moe.add_aux_loss``) with its
gradient path intact; the backward's re-run collects into its own list,
which is thrown away, so nothing is appended twice.  The re-run also
runs inside ``nn.functional.norm.recompute_replay()``, so a batch norm
in the region updates its running statistics once a step.

A module's parameters enter the checkpointed region as inputs and its
buffers through the region's closure, each bound as it is at the
forward.  Under ``torch.func.functional_call`` (the trainer's
half-precision copies of the f32 masters) the module holds the
swapped-in tensors only while the call runs; the backward's re-run gets
the same tensors back instead of whatever the module holds by then.  A
buffer is no input of the region because a batch norm writes its
running statistics in place, which a saved input may not take.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from ..nn.functional.norm import recompute_replay
from .moe import add_aux_loss, collect_aux_losses

__all__ = ["recompute", "checkpoint_policy", "POLICIES"]

POLICIES = ("full", "dots", "dots_no_batch", "nothing", "everything")

_aten = torch.ops.aten
_DOTS = {"dots": frozenset({_aten.mm.default, _aten.addmm.default,
                            _aten.bmm.default, _aten.baddbmm.default}),
         "dots_no_batch": frozenset({_aten.mm.default,
                                     _aten.addmm.default})}


def _policy_fn(name: str, ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS[name] \
        else CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint_policy(name: Optional[str]) -> Optional[Callable]:
    """The selective policy function for a
    ``strategy.recompute_configs['policy']`` name (``(ctx, op, *args,
    **kwargs) -> CheckpointPolicy``), or None where no selective policy
    runs: full recompute (``None``, ``'full'``, ``'nothing'``) or none at
    all (``'everything'``).  An unknown name raises ``ValueError``."""
    if name is not None and name not in POLICIES:
        raise ValueError(f"unknown recompute policy {name!r}")
    return functools.partial(_policy_fn, name) if name in _DOTS else None


def recompute(function, *args, policy: Optional[str] = None, **kwargs):
    """Run ``function(*args, **kwargs)`` and recompute it in the
    backward, keeping what ``policy`` names."""
    policy_fn = checkpoint_policy(policy)
    if policy == "everything":
        return function(*args, **kwargs)
    if isinstance(function, torch.nn.Module):
        module = function
        named = dict(module.named_parameters())
        names, tensors = list(named), list(named.values())
        buffers = dict(module.named_buffers())

        def function(*flat, **kw):
            bound = dict(zip(names, flat[:len(names)]))
            bound.update(buffers)
            return torch.func.functional_call(module, bound,
                                              flat[len(names):], kw)

        args = (*tensors, *args)
    if policy_fn is not None:
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy_fn)

    runs = []

    def region(*a, **kw):
        # every run after the first is the backward's replay
        replay = recompute_replay() if runs else contextlib.nullcontext()
        runs.append(1)
        with collect_aux_losses() as aux, replay:
            out = function(*a, **kw)
        return out, tuple(aux)

    out, aux = torch.utils.checkpoint.checkpoint(
        region, *args, use_reentrant=False, **kwargs)
    for loss in aux:
        add_aux_loss(loss)
    return out
