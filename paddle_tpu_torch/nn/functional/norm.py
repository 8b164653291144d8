"""``layer_norm`` (counterpart of ``paddle_tpu/nn/functional/norm.py``;
batch, instance and group norm come with the vision slice, ROADMAP.md
Queue 1)."""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Normalizes over the trailing ``normalized_shape`` dims in f32 and
    casts back to the input dtype, as the JAX ``layer_norm`` does."""
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    shape = tuple(normalized_shape)
    out = torch.nn.functional.layer_norm(
        x.float(), shape, None if weight is None else weight.float(),
        None if bias is None else bias.float(), epsilon)
    return out.to(x.dtype)
