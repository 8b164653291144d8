"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``).

Every loss of the JAX package with its arguments and formulas; each
casts its inputs by its op name under ``amp.auto_cast``.
``cross_entropy`` (hard labels with ``ignore_index`` and ``weight``, or
``soft_label=True`` targets, ``label_smoothing``) works in f32, f64 for
f64 logits.  ``ctc_loss`` runs the JAX package's CTC forward recursion
(``'mean'`` divides each loss by its label length).
"""
from __future__ import annotations

import torch
from torch.nn import functional as TF

from ... import ops
from ...amp.auto_cast import cast_inputs

__all__ = [
    "cross_entropy", "fused_linear_cross_entropy",
    "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "mse_loss", "l1_loss", "nll_loss",
    "kl_div", "smooth_l1_loss", "margin_ranking_loss", "hinge_embedding_loss",
    "cosine_embedding_loss", "ctc_loss", "log_loss", "square_error_cost",
    "sigmoid_focal_loss", "triplet_margin_loss", "dice_loss",
    "hsigmoid_loss", "npair_loss",
]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    if reduction == "none":
        return out
    raise ValueError(f"reduction must be 'none', 'mean' or 'sum', got "
                     f"{reduction!r}")


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy over ``axis``.  Hard integer labels (a
    trailing size-1 axis allowed): rows labelled ``ignore_index`` give
    0, ``'mean'`` divides by the count of the other rows (min 1), or by
    the sum of their ``weight``s.  ``soft_label=True``: ``label`` is a
    distribution over ``axis``."""
    input, label, weight = cast_inputs("cross_entropy", input, label,
                                       weight)
    acc = torch.promote_types(input.dtype, torch.float32)
    x = input.to(acc)
    logp = torch.log_softmax(x, dim=axis) if use_softmax \
        else torch.log(x.clamp(1e-15, 1.0))
    k = input.shape[axis]
    if soft_label:
        tgt = label.to(acc)
        if label_smoothing > 0:
            tgt = (1 - label_smoothing) * tgt + label_smoothing / k
        return _reduce(-(tgt * logp).sum(axis), reduction)
    lab = label.long()
    if lab.dim() == logp.dim():
        lab = lab.squeeze(axis)
    mask = lab != ignore_index
    safe = torch.where(mask, lab, torch.zeros_like(lab))
    if label_smoothing > 0:
        onehot = torch.movedim(TF.one_hot(safe, k).to(acc), -1, axis)
        tgt = (1 - label_smoothing) * onehot + label_smoothing / k
        loss = -(tgt * logp).sum(axis)
    else:
        loss = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(mask, loss, _zero(loss))
    if weight is not None:
        wl = torch.where(mask, weight.to(acc)[safe], _zero(loss))
        loss = loss * wl
        if reduction == "mean":
            return loss.sum() / wl.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / mask.sum().to(acc).clamp_min(1.0)
    return _reduce(loss, reduction)


def fused_linear_cross_entropy(input, weight, label, ignore_index=-100,
                               reduction="mean", block_size=None,
                               name=None):
    """Cross-entropy of ``input @ weight.T`` (input ``[N, H]``, weight
    ``[V, H]``: the tied LM head) computed over vocab chunks without the
    ``[N, V]`` logits (``ops.fused_linear_cross_entropy``)."""
    return ops.fused_linear_cross_entropy(
        input, weight, label, ignore_index=ignore_index,
        reduction=reduction, block_size=block_size)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-row losses keeping the label's trailing axis."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if not soft_label and loss.dim() < label.dim():
        loss = loss.unsqueeze(axis)
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    input, label, weight = cast_inputs("binary_cross_entropy", input, label,
                                       weight)
    p = input.float().clamp(1e-12, 1.0 - 1e-12)
    out = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if weight is not None:
        out = out * weight
    return _reduce(out, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    logit, label, weight, pos_weight = cast_inputs(
        "bce_with_logits", logit, label, weight, pos_weight)
    z = logit.float()
    t = label.float()
    if pos_weight is not None:
        log_w = (pos_weight - 1) * t + 1
        out = (1 - t) * z + log_w * (
            torch.logaddexp(_zero(z), -z.abs()) + torch.clamp(-z, min=0.0))
    else:
        out = torch.clamp(z, min=0.0) - z * t + \
            torch.logaddexp(_zero(z), -z.abs())
    if weight is not None:
        out = out * weight
    return _reduce(out, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    input, label = cast_inputs("mse_loss", input, label)
    return _reduce((input - label) ** 2, reduction)


def square_error_cost(input, label):
    input, label = cast_inputs("square_error_cost", input, label)
    return (input - label) ** 2


def l1_loss(input, label, reduction="mean", name=None):
    input, label = cast_inputs("l1_loss", input, label)
    return _reduce((input - label).abs(), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``input``: log-probabilities ``[N, C, ...]``."""
    input, label, weight = cast_inputs("nll_loss", input, label, weight)
    t = label.long()
    mask = t != ignore_index
    safe = torch.where(mask, t, torch.zeros_like(t))
    picked = input.gather(1, safe.unsqueeze(1)).squeeze(1)
    wl = (weight[safe] * mask) if weight is not None \
        else mask.to(input.dtype)
    loss = -picked * wl
    if reduction == "mean":
        return loss.sum() / wl.sum().clamp_min(1e-12)
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    input, label = cast_inputs("kl_div", input, label)
    out = label * (torch.log(label.clamp_min(1e-12)) - input)
    if reduction == "batchmean":
        return out.sum() / input.shape[0]
    return _reduce(out, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    input, label = cast_inputs("smooth_l1_loss", input, label)
    d = (input - label).abs()
    return _reduce(torch.where(d < delta, 0.5 * d * d / delta,
                               d - 0.5 * delta), reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    input, other, label = cast_inputs("margin_ranking_loss", input, other,
                                      label)
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    input, label = cast_inputs("hinge_embedding_loss", input, label)
    return _reduce(torch.where(label == 1.0, input,
                               torch.clamp(margin - input, min=0.0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    input1, input2, label = cast_inputs("cosine_embedding_loss", input1,
                                        input2, label)
    cos = (input1 * input2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), min=1e-12)
    return _reduce(torch.where(label == 1, 1 - cos,
                               torch.clamp(cos - margin, min=0.0)),
                   reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    input, label = cast_inputs("log_loss", input, label)
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    logit, label, normalizer = cast_inputs("sigmoid_focal_loss", logit,
                                           label, normalizer)
    p = torch.sigmoid(logit)
    ce = torch.clamp(logit, min=0.0) - logit * label + \
        torch.logaddexp(_zero(logit), -logit.abs())
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    out = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        out = out / normalizer
    return _reduce(out, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean", name=None):
    input, positive, negative = cast_inputs("triplet_margin_loss", input,
                                            positive, negative)

    def dist(a, b):
        return ((a - b).abs() ** p).sum(-1).add(epsilon) ** (1 / p)

    dp = dist(input, positive)
    dn = dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over log-probabilities ``[T, N, C]`` and padded labels
    ``[N, S]``: the forward recursion over the blank-extended labels in
    log space (-1e30 for impossible states), differentiated by autograd,
    so the gradient is exact for any input (normalized or not)."""
    lp, labels, input_lengths, label_lengths = cast_inputs(
        "ctc_loss", log_probs, labels, input_lengths, label_lengths)
    t_len, n, _ = lp.shape
    s = labels.shape[1]
    lab = labels.long()
    ext = torch.full((n, 2 * s + 1), blank, dtype=torch.long,
                     device=lp.device)
    ext[:, 1::2] = lab
    ext_len = 2 * label_lengths.long() + 1
    neg = torch.full((n, 1), -1e30, dtype=lp.dtype, device=lp.device)
    alpha = lp[0][:, blank:blank + 1]
    if s > 0:
        alpha = torch.cat([alpha, lp[0].gather(1, ext[:, 1:2]),
                           neg.expand(n, 2 * s - 1)], dim=1)
    repeat = torch.cat([torch.ones((n, 2), dtype=torch.bool,
                                   device=lp.device),
                        ext[:, 2:] == ext[:, :-2]], dim=1)
    alphas = [alpha]
    for t in range(1, t_len):
        shift1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        shift2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)
        shift2 = torch.where(repeat, neg, shift2)
        merged = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2)
        alpha = merged + lp[t].gather(1, ext)
        alphas.append(alpha)
    alphas = torch.stack(alphas)
    t_idx = (input_lengths.long() - 1).clamp(0, t_len - 1)
    final = alphas[t_idx, torch.arange(n, device=lp.device)]
    last = (ext_len - 1).clamp(0, 2 * s)
    ll = torch.logaddexp(final.gather(1, last[:, None])[:, 0],
                         final.gather(1, (last - 1).clamp_min(0)[:, None])
                         [:, 0])
    loss = -ll
    if reduction == "mean":
        return (loss / label_lengths.to(loss.dtype).clamp_min(1)).mean()
    return _reduce(loss, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``1 - 2|X ∩ Y| / (|X| + |Y|)`` per example, averaged."""
    input, label = cast_inputs("dice_loss", input, label)
    if label.shape != input.shape:
        label = TF.one_hot(label.squeeze(-1).long(),
                           input.shape[-1]).to(input.dtype)
    else:
        label = label.to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = (input * label).sum(dims)
    union = input.sum(dims) + label.sum(dims)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    anchor, positive, labels = cast_inputs("npair_loss", anchor, positive,
                                           labels)
    sim = anchor @ positive.T
    same = (labels.reshape(-1, 1) == labels.reshape(1, -1)).to(anchor.dtype)
    tgt = same / same.sum(1, keepdim=True).clamp_min(1)
    ce = -(tgt * torch.log_softmax(sim, dim=1)).sum(1).mean()
    reg = l2_reg * ((anchor * anchor).sum() + (positive * positive).sum()) \
        / (2.0 * anchor.shape[0])
    return ce + reg


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss ``[N, 1]``: the default tree is the
    complete binary tree over ``num_classes`` leaves (class c's heap code
    ``c + num_classes``; node of bit j ``(code >> (j + 1)) - 1``, target
    bit ``(code >> j) & 1``); a custom tree comes as ``path_table`` /
    ``path_code`` ``[N, L]`` padded with -1."""
    input, label, weight, bias = cast_inputs("hsigmoid_loss", input, label,
                                             weight, bias)
    lab = label.reshape(-1).long()
    if path_table is not None:
        tbl = path_table.long()
        valid = (tbl >= 0).float()
        idx = tbl.clamp_min(0)
        bits = path_code.float()
    else:
        max_len = max((2 * num_classes - 1).bit_length() - 1, 1)
        c = lab + num_classes
        js = torch.arange(max_len, device=lab.device)
        idx = (c[:, None] >> (js[None, :] + 1)) - 1
        bits = ((c[:, None] >> js[None, :]) & 1).float()
        valid = (idx >= 0).float()
        idx = idx.clamp_min(0)
    s = torch.einsum("nf,nlf->nl", input.float(), weight[idx].float())
    if bias is not None:
        s = s + bias.reshape(-1)[idx].float()
    per_bit = TF.softplus(s) - bits * s
    return (per_bit * valid).sum(1, keepdim=True)
