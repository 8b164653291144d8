from .activation import *  # noqa: F401,F403
from .activation import __all__ as _act
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .container import *  # noqa: F401,F403
from .container import __all__ as _container
from .conv import *  # noqa: F401,F403
from .conv import __all__ as _conv
from .distance import *  # noqa: F401,F403
from .distance import __all__ as _distance
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pool
from .rnn import *  # noqa: F401,F403
from .rnn import __all__ as _rnn
from .transformer import *  # noqa: F401,F403
from .transformer import __all__ as _transformer

__all__ = [*_act, *_common, *_container, *_conv, *_distance, *_loss,
           *_norm, *_pool, *_rnn, *_transformer]
