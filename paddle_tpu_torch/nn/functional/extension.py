"""``paddle.nn.functional.extension`` (counterpart of
``paddle_tpu/nn/functional/extension.py``): ``diag_embed``, and
``gather_tree`` beside it."""
from ...tensor.creation import diag_embed  # noqa: F401
from ...text.decoding import gather_tree  # noqa: F401

__all__ = ["diag_embed", "gather_tree"]
