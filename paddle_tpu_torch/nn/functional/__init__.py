from .activation import gelu
from .attention import flash_attention

__all__ = ["gelu", "flash_attention"]
