from . import functional, initializer
from .layer import Dropout, Embedding, LayerNorm

__all__ = ["functional", "initializer", "Dropout", "Embedding", "LayerNorm"]
