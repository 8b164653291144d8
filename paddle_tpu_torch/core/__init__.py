from . import errors, flags, random
from .flags import get_flags, set_flags

__all__ = ["errors", "flags", "random", "get_flags", "set_flags"]
