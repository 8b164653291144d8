"""``paddle.nn.functional`` (counterpart of
``paddle_tpu/nn/functional``): common, activation, loss, norm and
attention functionals."""
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _act
from .attention import flash_attention, scaled_dot_product_attention
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import layer_norm

__all__ = [*_act, *_common, *_loss, "layer_norm", "flash_attention",
           "scaled_dot_product_attention"]
