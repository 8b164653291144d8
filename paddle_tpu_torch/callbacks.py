"""``paddle.callbacks`` (counterpart of ``paddle_tpu/callbacks.py``): the
``hapi`` callbacks."""
from .hapi.callbacks import (Callback, EarlyStopping, History, LRScheduler,
                             ModelCheckpoint, ProgBarLogger)

__all__ = ["Callback", "EarlyStopping", "History", "LRScheduler",
           "ModelCheckpoint", "ProgBarLogger"]
