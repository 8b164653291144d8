"""Kernel ops of the ported paths: each a hand-written CUDA kernel for
Hopper with its plain PyTorch version beside it (see ``_build``), and
the fused cross-entropy (plain products, no kernel of its own)."""
from .decode_attention import DECODE_ATTENTION, decode_attention
from .flash_attention import (FLASH_BWD_DKV, FLASH_BWD_DQ, FLASH_FWD,
                              flash_attention, flash_attention_fwd)
from .fused_cross_entropy import fused_linear_cross_entropy, pick_vocab_block

__all__ = ["decode_attention", "flash_attention", "flash_attention_fwd",
           "fused_linear_cross_entropy", "pick_vocab_block",
           "DECODE_ATTENTION", "FLASH_FWD", "FLASH_BWD_DQ", "FLASH_BWD_DKV",
           "KERNELS"]

# every kernel of the package by source file, for builds and launch counts
KERNELS = {"flash_fwd.cu": FLASH_FWD, "flash_bwd_dq.cu": FLASH_BWD_DQ,
           "flash_bwd_dkv.cu": FLASH_BWD_DKV,
           "decode_attention.cu": DECODE_ATTENTION}
