"""``paddle.nn`` (counterpart of ``paddle_tpu/nn``): ``Layer`` and
``ParamAttr``, the layer zoo (common, activation, loss, convolution,
pooling, the norms, distance, containers, transformer, the recurrent
layers; ``nn.vision``), the functionals, initializers, gradient
clipping, weight normalization (``nn.utils``) and the decoding API."""
from . import clip, decode, functional, initializer, utils
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .decode import BeamSearchDecoder, dynamic_decode
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers
from .layer import vision
from .layer_base import HookRemoveHelper, Layer, ParamAttr

__all__ = ["clip", "decode", "functional", "initializer", "utils",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "BeamSearchDecoder", "dynamic_decode", "Layer", "ParamAttr",
           "HookRemoveHelper", "vision", *_layers]
