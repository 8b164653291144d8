"""Attention ops of the serving path: each a hand-written CUDA kernel for
Hopper with its plain PyTorch version beside it (see ``_build``)."""
from .decode_attention import DECODE_ATTENTION, decode_attention
from .flash_attention import FLASH_FWD, flash_attention, flash_attention_fwd

__all__ = ["decode_attention", "flash_attention", "flash_attention_fwd",
           "DECODE_ATTENTION", "FLASH_FWD", "KERNELS"]

# every kernel of the package by source file, for builds and launch counts
KERNELS = {"flash_fwd.cu": FLASH_FWD, "decode_attention.cu": DECODE_ATTENTION}
