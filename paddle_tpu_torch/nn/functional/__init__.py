from .activation import gelu
from .attention import flash_attention
from .loss import cross_entropy, fused_linear_cross_entropy

__all__ = ["gelu", "flash_attention", "cross_entropy",
           "fused_linear_cross_entropy"]
