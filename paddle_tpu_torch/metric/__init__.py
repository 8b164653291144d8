"""``paddle.metric`` (counterpart of ``paddle_tpu/metric``)."""
from .metrics import (Accuracy, Auc, Metric, Precision, Recall, accuracy,
                      mean_iou)

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy",
           "mean_iou"]
