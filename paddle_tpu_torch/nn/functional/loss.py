"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``):
the two the GPT pretraining criterion uses."""
from __future__ import annotations

import torch

from ... import ops

__all__ = ["cross_entropy", "fused_linear_cross_entropy"]


def cross_entropy(input: torch.Tensor, label: torch.Tensor,
                  ignore_index: int = -100,
                  reduction: str = "mean") -> torch.Tensor:
    """Softmax cross-entropy over the last axis against hard integer
    labels, in f32 (f64 for f64 logits) like the JAX one: rows labelled
    ``ignore_index`` give 0, and 'mean' divides by the count of the
    other rows (min 1).  ``label`` may carry a trailing size-1 axis."""
    acc = torch.promote_types(input.dtype, torch.float32)
    logp = torch.log_softmax(input.to(acc), dim=-1)
    lab = label.long()
    if lab.dim() == logp.dim():
        lab = lab.squeeze(-1)
    mask = lab != ignore_index
    safe = torch.where(mask, lab, torch.zeros_like(lab))
    loss = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    loss = torch.where(mask, loss, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.sum() / mask.sum().to(acc).clamp_min(1.0)
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction must be 'none', 'mean' or 'sum', got "
                     f"{reduction!r}")


def fused_linear_cross_entropy(input: torch.Tensor, weight: torch.Tensor,
                               label: torch.Tensor, ignore_index: int = -100,
                               reduction: str = "mean",
                               block_size=None) -> torch.Tensor:
    """Cross-entropy of ``input @ weight.T`` (input ``[N, H]``, weight
    ``[V, H]``: the tied LM head) computed over vocab chunks without the
    ``[N, V]`` logits (``ops.fused_linear_cross_entropy``)."""
    return ops.fused_linear_cross_entropy(
        input, weight, label, ignore_index=ignore_index,
        reduction=reduction, block_size=block_size)
