"""``paddle.nn.utils`` (counterpart of ``paddle_tpu/nn/utils``): weight
normalization."""
from . import weight_norm_hook
from .weight_norm_hook import remove_weight_norm, weight_norm

__all__ = ["weight_norm", "remove_weight_norm"]
