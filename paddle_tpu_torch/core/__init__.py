from . import random

__all__ = ["random"]
