"""``paddle.utils`` (counterpart of part of ``paddle_tpu/utils``): the
unique-name scopes."""
from . import unique_name

__all__ = ["unique_name"]
