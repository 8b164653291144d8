"""LayerNorm (counterpart of ``paddle_tpu/nn/layer/norm.py``).

The batch, group, instance, local-response, spectral and RMS norms of
the JAX file come with the vision slice (ROADMAP.md Queue 1 item 3.5):
their names exist here and raise."""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
           "InstanceNorm3D", "SyncBatchNorm", "LocalResponseNorm",
           "SpectralNorm", "RMSNorm"]


class LayerNorm(Layer):
    """Normalizes over the trailing ``normalized_shape`` dims in f32 and
    casts back to the input dtype, as the JAX ``layer_norm`` does."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype)
        self._placement(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = tuple(int(n) for n in normalized_shape)
        self.epsilon = float(epsilon)
        self.weight = self.create_parameter(
            self.normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            self.normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={list(self.normalized_shape)}"


def _waits(name: str):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"nn.{name} is not ported yet: it comes with the vision slice "
            f"(ROADMAP.md Queue 1 item 3.5)")
    return type(name, (Layer,), {"__init__": __init__,
                                 "__module__": __name__})


BatchNorm = _waits("BatchNorm")
BatchNorm1D = _waits("BatchNorm1D")
BatchNorm2D = _waits("BatchNorm2D")
BatchNorm3D = _waits("BatchNorm3D")
GroupNorm = _waits("GroupNorm")
InstanceNorm1D = _waits("InstanceNorm1D")
InstanceNorm2D = _waits("InstanceNorm2D")
InstanceNorm3D = _waits("InstanceNorm3D")
SyncBatchNorm = _waits("SyncBatchNorm")
LocalResponseNorm = _waits("LocalResponseNorm")
SpectralNorm = _waits("SpectralNorm")
RMSNorm = _waits("RMSNorm")
