"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

A clipper takes ``(param, grad)`` pairs (the eager form) or a dict of
gradients by name (``clip_arrays``, the trainer's form) and returns new
gradients.  Norms are taken in f32 and stay on the device: clipping
reads nothing back to the host.  A parameter with ``need_clip = False``
keeps its gradient in the eager form.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_by_global_norm_arrays"]


class ClipGradBase:
    def __call__(self, params_grads):
        return [(p, g if g is None or not getattr(p, "need_clip", True)
                 else self._clip_one(g)) for p, g in params_grads]

    def _clip_one(self, g: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def clip_arrays(self, grads: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        return {n: self._clip_one(g) for n, g in grads.items()}


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip_one(self, g):
        return g.clamp(self.min, self.max)


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to norm at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_one(self, g):
        norm = g.float().square().sum().sqrt()
        scale = (self.clip_norm / norm.clamp_min(1e-12)).clamp_max(1.0)
        return (g * scale).to(g.dtype)


def _global_scale(grads, clip_norm):
    gn = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    return (clip_norm / gn.clamp_min(1e-12)).clamp_max(1.0), gn


def clip_by_global_norm_arrays(grads: Dict[str, torch.Tensor], clip_norm):
    """Global-norm clip of a dict of gradients; returns (clipped, norm)."""
    scale, gn = _global_scale(list(grads.values()), float(clip_norm))
    return {n: (g * scale).to(g.dtype) for n, g in grads.items()}, gn


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled together so that their joint norm is at
    most ``clip_norm``."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def __call__(self, params_grads):
        clipped = [g for p, g in params_grads
                   if g is not None and getattr(p, "need_clip", True)]
        if not clipped:
            return params_grads
        scale, _ = _global_scale(clipped, self.clip_norm)
        return [(p, g if g is None or not getattr(p, "need_clip", True)
                 else (g * scale).to(g.dtype)) for p, g in params_grads]

    def clip_arrays(self, grads):
        return clip_by_global_norm_arrays(grads, self.clip_norm)[0]
