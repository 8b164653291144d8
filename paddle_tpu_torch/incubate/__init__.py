"""Experimental API (counterpart of ``paddle_tpu/incubate``): the
``LookAhead`` and ``ModelAverage`` optimizers."""
from . import optimizer
from .optimizer import LookAhead, ModelAverage

__all__ = ["optimizer", "LookAhead", "ModelAverage"]
