"""Optimizers, learning-rate schedules and the parameter EMA
(counterpart of ``paddle_tpu/optimizer``)."""
from . import lr
from .ema import ExponentialMovingAverage
from .optimizer import Optimizer
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                         Lars, Momentum, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adagrad", "RMSProp",
           "Adadelta", "Adam", "AdamW", "Adamax", "Lamb", "Lars",
           "ExponentialMovingAverage"]
