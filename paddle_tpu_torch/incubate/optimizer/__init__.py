from .lookahead import LookAhead
from .modelaverage import ModelAverage

__all__ = ["LookAhead", "ModelAverage"]
