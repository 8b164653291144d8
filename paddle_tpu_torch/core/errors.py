"""Typed errors (counterpart of ``paddle_tpu/core/errors.py``): the part
of the JAX package's hierarchy the port raises, with the same bases, so
``except KeyError`` catches an unknown flag as it does there."""
from __future__ import annotations

__all__ = ["EnforceNotMet", "NotFoundError", "PreconditionNotMetError",
           "InvalidArgumentError"]


class EnforceNotMet(RuntimeError):
    """Base of the framework's errors."""


class NotFoundError(EnforceNotMet, KeyError):
    pass


class PreconditionNotMetError(EnforceNotMet):
    pass


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass
