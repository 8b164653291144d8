"""Metrics (counterpart of ``paddle_tpu/metric/metrics.py``): ``Metric``,
``Accuracy``, ``Precision``, ``Recall``, ``Auc``, ``accuracy``,
``mean_iou``.

``Accuracy.compute`` runs on the predictions' device (top-k by
``torch.topk``) and ``update`` keeps its running totals there, so a
training step reads nothing back for it; ``accumulate()`` is the one
read.  The others accumulate on the host from numpy, as in the JAX
package.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy",
           "mean_iou"]


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        """Optional pre-compute on the outputs (default: passthrough)."""
        return args


def _squeeze_label(label, pred):
    if label.dim() == pred.dim() and label.shape[-1] == 1:
        return label.squeeze(-1)
    return label


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        self.topk = topk if isinstance(topk, (tuple, list)) else (topk,)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        """``[..., maxk]`` f32: whether the i-th best class is the
        label."""
        pred = pred if torch.is_tensor(pred) else torch.as_tensor(_np(pred))
        label = torch.as_tensor(label, device=pred.device) \
            if not torch.is_tensor(label) else label.to(pred.device)
        label = _squeeze_label(label, pred)
        order = torch.topk(pred.detach(), max(self.topk), dim=-1).indices
        return (order == label[..., None]).float()

    def update(self, correct, *args):
        """Add a batch's ``compute`` result; returns the running
        accuracy as a device scalar (or a list of them)."""
        c = correct if torch.is_tensor(correct) \
            else torch.as_tensor(_np(correct))
        n = int(np.prod(c.shape[:-1]))
        for i, k in enumerate(self.topk):
            self.total[i] = self.total[i] + c[..., :k].sum()
            self.count[i] += n
        res = [t / c_ if c_ > 0 else 0.0
               for t, c_ in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def accumulate(self):
        res = [float(t) / c if c > 0 else 0.0
               for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision", *args, **kwargs):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall", *args, **kwargs):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """Histogram-bucket ROC AUC over ``num_thresholds`` buckets."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc",
                 *args, **kwargs):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        l = _np(labels).astype(np.int32).reshape(-1)
        idx = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        np.add.at(self._stat_pos, idx[l == 1], 1)
        np.add.at(self._stat_neg, idx[l == 0], 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tpr = np.cumsum(self._stat_pos[::-1]) / tot_pos
        fpr = np.cumsum(self._stat_neg[::-1]) / tot_neg
        trapz = getattr(np, "trapezoid", None) or np.trapz
        return float(trapz(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-k accuracy of a batch as an f32 scalar tensor."""
    label = _squeeze_label(label, input)
    topk = torch.topk(input, k, dim=-1).indices
    return (topk == label[..., None]).any(-1).float().mean()


def mean_iou(input, label, num_classes):
    """``(mean IoU, wrong [C], correct [C])`` over a segmentation batch:
    a mismatching pixel counts as wrong for both its predicted and its
    true class; classes with no pixels are left out of the mean."""
    pred = _np(input).astype(np.int64).reshape(-1)
    gt = _np(label).astype(np.int64).reshape(-1)
    correct = np.zeros(num_classes, np.int64)
    wrong = np.zeros(num_classes, np.int64)
    hit = pred == gt

    def in_range(a):
        return (a >= 0) & (a < num_classes)

    np.add.at(correct, pred[hit & in_range(pred)], 1)
    np.add.at(wrong, pred[~hit & in_range(pred)], 1)
    np.add.at(wrong, gt[~hit & in_range(gt)], 1)
    denom = correct + wrong
    valid = denom > 0
    iou = correct / np.maximum(denom, 1)
    miou = float(iou[valid].mean()) if valid.any() else 0.0
    return miou, wrong, correct
