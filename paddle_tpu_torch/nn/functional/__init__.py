"""``paddle.nn.functional`` (counterpart of
``paddle_tpu/nn/functional``): common, activation, loss, convolution,
pooling, norm, vision and attention functionals."""
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _act
from .attention import flash_attention, scaled_dot_product_attention
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .conv import *  # noqa: F401,F403
from .conv import __all__ as _conv
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pool
from .vision import *  # noqa: F401,F403
from .vision import __all__ as _vision

__all__ = [*_act, *_common, *_conv, *_loss, *_norm, *_pool, *_vision,
           "flash_attention", "scaled_dot_product_attention"]
