"""``paddle.tensor``, the op library (counterpart of
``paddle_tpu/tensor``): functions on ``torch.Tensor`` that keep the JAX
package's names, arguments and meaning.  Its namespace holds every
public name of the JAX one, the helpers that namespace exposes
(``Tensor``, ``apply``, ``convert_dtype``, ...) included."""
import torch

from ..autograd import apply  # noqa: F401  (re-exports)
from ..core.dtype import convert_dtype, default_float_dtype  # noqa: F401
from ..core.errors import InvalidArgumentError  # noqa: F401
from ..core.random import next_key  # noqa: F401
from ..core.tensor import is_tensor, to_tensor  # noqa: F401
from . import (array, attribute, creation, einsum, linalg, logic,
               manipulation, math, random, search, sequence)
from .array import *  # noqa: F401,F403
from .attribute import *  # noqa: F401,F403
from .creation import *  # noqa: F401,F403
from .einsum import einsum  # noqa: F811
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403

Tensor = torch.Tensor

__all__ = sorted({*array.__all__, *attribute.__all__, *creation.__all__,
                  "einsum", *linalg.__all__, *logic.__all__,
                  *manipulation.__all__, *math.__all__, *random.__all__,
                  *search.__all__, *sequence.__all__, "Tensor", "to_tensor",
                  "is_tensor", "apply", "convert_dtype",
                  "default_float_dtype", "InvalidArgumentError",
                  "next_key"})
