"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package keeps its
module names and layouts and runs on one NVIDIA Hopper GPU.  Every
Pallas kernel on a ported path becomes a hand-written CUDA kernel
(``csrc/``, built at first use by ``ops._build``) with its plain PyTorch
version beside it; a CPU tensor runs the plain version, a CUDA tensor
the kernel or an error.  Entry points default to the CUDA device and
raise without one; pass ``device="cpu"`` to run on the CPU.

Ported so far: single-GPU GPT serving on the dense KV cache
(``models.gpt``, ``inference.engine``) with the flash-attention forward
and decode-attention kernels, and the single-GPU GPT training step
(``distributed.SpmdTrainer``, ``optimizer``, ``io.DevicePrefetcher``,
the fused cross-entropy) with the flash-attention backward kernels.
"""
from . import (core, device, distributed, inference, io, models, nn, ops,
               optimizer)
from .device import resolve_device

__all__ = ["core", "device", "distributed", "inference", "io", "models",
           "nn", "ops", "optimizer", "resolve_device"]
