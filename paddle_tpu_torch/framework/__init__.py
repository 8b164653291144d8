"""``paddle.framework`` (counterpart of ``paddle_tpu/framework``): dtype
defaults, ``seed``, ``save`` / ``load`` and the file systems (``fs``)."""
from ..core.dtype import get_default_dtype, set_default_dtype
from ..core.random import set_seed as seed
from . import fs
from .io import load, save

__all__ = ["fs", "get_default_dtype", "set_default_dtype", "seed", "save", "load"]
