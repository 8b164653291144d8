from . import clip, decode, functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .decode import BeamSearchDecoder, dynamic_decode
from .layer import Dropout, Embedding, LayerNorm

__all__ = ["clip", "decode", "functional", "initializer",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "BeamSearchDecoder", "dynamic_decode", "Dropout", "Embedding",
           "LayerNorm"]
