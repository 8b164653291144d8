"""``paddle.nn.vision`` (counterpart of ``paddle_tpu/nn/layer/vision.py``):
the pixel and channel shuffles and the upsampling layers, which live in
``common.py``."""
from .common import (ChannelShuffle, PixelShuffle,  # noqa: F401
                     PixelUnshuffle, Upsample, UpsamplingBilinear2D,
                     UpsamplingNearest2D)

__all__ = ["PixelShuffle", "PixelUnshuffle", "ChannelShuffle",
           "Upsample", "UpsamplingBilinear2D", "UpsamplingNearest2D"]
