"""Activation recompute (counterpart of
``paddle_tpu/distributed/recompute.py``).

``recompute(fn, *args)`` runs ``fn`` without keeping its inner
activations; the backward runs its forward again
(``torch.utils.checkpoint``, non-reentrant).  Only full recompute is
ported: the JAX package's selective policies (``jax.checkpoint_policies``
that keep matmul outputs) raise here instead of silently recomputing
everything.

A module's parameters and buffers enter the checkpointed region as
inputs, bound as they are at the forward.  Under
``torch.func.functional_call`` (the trainer's bf16 copies of the f32
masters) the module holds the swapped-in tensors only while the call
runs; the backward's re-run gets the same tensors back from the inputs
instead of whatever the module holds by then.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

__all__ = ["recompute", "check_policy"]

# the JAX package's named policies other than full recompute
_SELECTIVE = ("dots", "dots_no_batch", "nothing", "everything")


def check_policy(policy: Optional[str]) -> None:
    """Accept full recompute (``None`` or ``'full'``); raise on anything
    else."""
    if policy is None or policy == "full":
        return
    if policy in _SELECTIVE:
        raise NotImplementedError(
            f"recompute policy {policy!r} (selective save) is not ported "
            f"yet; only full recompute (policy=None or 'full') is: see "
            f"ROADMAP.md, Queue 1")
    raise ValueError(f"unknown recompute policy {policy!r}")


def recompute(function, *args, policy: Optional[str] = None, **kwargs):
    """Run ``function(*args, **kwargs)`` and recompute it in the
    backward instead of saving its activations."""
    check_policy(policy)
    if isinstance(function, torch.nn.Module):
        module = function
        named = dict(module.named_parameters())
        named.update(module.named_buffers())
        names, tensors = list(named), list(named.values())

        def function(*flat, **kw):
            bound = dict(zip(names, flat[:len(names)]))
            return torch.func.functional_call(module, bound,
                                              flat[len(names):], kw)

        args = (*tensors, *args)
    return torch.utils.checkpoint.checkpoint(function, *args,
                                             use_reentrant=False, **kwargs)
