"""Blocked softmax cross-entropy over a linear vocabulary head.

Counterpart of ``paddle_tpu/ops/fused_cross_entropy.py``: the loss of
``hidden @ weight.T`` against integer labels, computed one vocab chunk
at a time with a running max and denominator, so the ``[N, V]`` logits
tensor never exists (peak extra memory is one ``[N, block]`` tile).
The backward recomputes each chunk's logits from the saved per-row lse
(saved: hidden, weight, labels, lse) and produces d(hidden) and
d(weight) chunk by chunk.  Rows whose label is ``ignore_index`` give
loss 0 and no gradient.

The JAX package has no Pallas kernel here (XLA dot_general), so the
products are ``torch.matmul``.  Precision: JAX takes the logits from
the storage-dtype operands with f32 accumulation and runs the backward
products on f32 operands.  The port casts both operands to f32 and, on
the card, runs the products in TF32 (``allow_tf32`` set for the op and
restored after): a bf16 operand is exact in TF32's 10-bit mantissa, so
the forward logits equal JAX's bf16 x bf16 -> f32 products, and the
backward's f32 ``d_logits`` keep 10 mantissa bits (the TPU's default
precision keeps 8).  A bf16 ``torch.matmul`` would instead round every
logit to bf16 before the logsumexp.  On the CPU the products are plain
f32 (f64 for f64 inputs).

The last chunk is simply shorter where JAX pads the weight to a
multiple of the chunk and masks the padding: the same sums without a
padded copy of the weight.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["fused_linear_cross_entropy", "pick_vocab_block"]

_NEG = -1e30


def pick_vocab_block(vocab_size: int, want: int = 2048) -> int:
    """Largest power-of-two chunk <= ``want`` that is <= vocab_size."""
    b = 1
    while b * 2 <= min(want, vocab_size):
        b *= 2
    return b


@contextlib.contextmanager
def _tf32(device: torch.device):
    """TF32 tensor-core products for f32 operands on the card, restored
    on exit; nothing changes on the CPU."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _chunks(v: int, block: int):
    return [(c0, min(c0 + block, v)) for c0 in range(0, v, block)]


class _BlockedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, weight, labels, block, ignore_index):
        acc = torch.promote_types(hidden.dtype, torch.float32)
        n = hidden.shape[0]
        h = hidden.to(acc)
        m = torch.full((n,), _NEG, dtype=acc, device=hidden.device)
        l = torch.zeros(n, dtype=acc, device=hidden.device)
        lab_logit = torch.zeros(n, dtype=acc, device=hidden.device)
        with _tf32(hidden.device):
            for c0, c1 in _chunks(weight.shape[0], block):
                logits = torch.matmul(h, weight[c0:c1].to(acc).t())
                m_new = torch.maximum(m, logits.amax(dim=1))
                l = l * torch.exp(m - m_new) + \
                    torch.exp(logits - m_new[:, None]).sum(dim=1)
                m = m_new
                off = labels - c0
                in_blk = (off >= 0) & (off < c1 - c0)
                picked = logits.gather(
                    1, off.clamp(0, c1 - c0 - 1)[:, None])[:, 0]
                lab_logit = torch.where(in_blk, picked, lab_logit)
        lse = m + torch.log(l.clamp_min(1e-30))
        valid = labels != ignore_index
        loss = torch.where(valid, lse - lab_logit, torch.zeros_like(lse))
        ctx.save_for_backward(hidden, weight, labels, lse)
        ctx.block, ctx.ignore_index = block, ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, weight, labels, lse = ctx.saved_tensors
        acc = lse.dtype
        h = hidden.to(acc)
        # rows with ignored labels contribute no gradient
        gv = (g * (labels != ctx.ignore_index)).to(acc)
        dx = torch.zeros_like(h)
        dw = torch.empty_like(weight)
        with _tf32(hidden.device):
            for c0, c1 in _chunks(weight.shape[0], ctx.block):
                w_blk = weight[c0:c1].to(acc)
                logits = torch.matmul(h, w_blk.t())
                p = torch.exp(logits - lse[:, None])
                cols = torch.arange(c0, c1, device=labels.device)
                onehot = (labels[:, None] == cols[None, :]).to(acc)
                d_logits = (p - onehot) * gv[:, None]
                dx += torch.matmul(d_logits, w_blk)
                dw[c0:c1] = torch.matmul(d_logits.t(), h).to(weight.dtype)
        return dx.to(hidden.dtype), dw, None, None, None


def fused_linear_cross_entropy(hidden, weight, labels, ignore_index=-100,
                               reduction="mean", block_size=None):
    """Softmax cross-entropy of ``hidden @ weight.T`` against integer
    ``labels`` without materializing the ``[N, V]`` logits.

    hidden ``[N, H]``; weight ``[V, H]`` (embedding layout: the tied LM
    head); labels ``[N]`` (or ``[N, 1]``) int.  reduction: 'none' |
    'mean' | 'sum'; 'mean' divides by the count of non-ignored rows
    (min 1).  The loss is f32 (f64 for f64 inputs)."""
    labels = labels.long()
    if labels.dim() == 2 and labels.shape[-1] == 1:
        labels = labels[:, 0]
    block = block_size or pick_vocab_block(weight.shape[0])
    loss = _BlockedCE.apply(hidden, weight, labels, int(block),
                            int(ignore_index))
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction != "mean":
        raise ValueError(f"reduction must be 'none', 'mean' or 'sum', got "
                         f"{reduction!r}")
    denom = (labels != ignore_index).sum().to(loss.dtype).clamp_min(1.0)
    return loss.sum() / denom
