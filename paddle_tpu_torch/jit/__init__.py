"""``paddle.jit`` (counterpart of ``paddle_tpu/jit``): ``to_static``
captures a layer's forward with ``torch.export`` and runs the captured
program; ``save`` writes the captured inference program and the
weights, ``load`` returns a ``TranslatedLayer`` that runs them."""
from .api import (  # noqa: F401
    to_static, not_to_static, StaticFunction, save, load, TranslatedLayer,
    in_tracing, enable_to_static)

__all__ = ["to_static", "not_to_static", "StaticFunction", "save", "load",
           "TranslatedLayer", "in_tracing", "enable_to_static"]
