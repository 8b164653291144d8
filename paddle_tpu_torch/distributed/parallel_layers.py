"""Single-device forms of the tensor-parallel layers (counterpart of
``paddle_tpu/distributed/parallel_layers.py``).

Weights keep the JAX layout ``[in_features, out_features]`` (so
``y = x @ W + b``) and the JAX parameter names, which lets
``models.convert`` move weights between the packages without a
transpose.  ``quantize='int8'`` routes the product through
``ops.fake_quant_matmul`` (quantized forward, straight-through backward),
the bias added in full precision after it.  Sharding over a
tensor-parallel axis comes with the multi-device slice.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn import initializer as I
from ..ops.quantized_matmul import fake_quant_matmul

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]


def _quantized_linear(x, weight, bias, mode: str):
    """``x @ W (+ b)`` through ``fake_quant_matmul``: quantized forward
    (per-channel amax scaling), straight-through backward; the bias rides
    full precision."""
    y = fake_quant_matmul(x, weight, mode)
    return y if bias is None else y + bias


class _Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 weight_init: I.Initializer = None, has_bias: bool = True, *,
                 device, dtype, generator, quantize: Optional[str] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        # read at every call: GPTModel.enable_quantize flips it
        self.quantize = quantize
        self.weight = I.make_parameter(
            (in_features, out_features), weight_init or I.XavierUniform(),
            device=device, dtype=dtype, generator=generator)
        self.bias = I.make_parameter((out_features,), 0.0, device=device,
                                     dtype=dtype, generator=None) \
            if has_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantize:
            return _quantized_linear(x, self.weight, self.bias,
                                     self.quantize)
        y = torch.matmul(x, self.weight)
        return y if self.bias is None else y + self.bias


class ColumnParallelLinear(_Linear):
    """``y = x @ W + b`` with W ``[in, out]`` (columns = the tp-sharded
    dimension in the multi-device form)."""


class RowParallelLinear(_Linear):
    """``y = x @ W`` then ``+ b``: the bias is added after the product,
    where the multi-device form adds it after the all-reduce."""


class VocabParallelEmbedding(nn.Module):
    """Embedding ``weight [vocab, hidden]`` (vocab = the tp-sharded
    dimension in the multi-device form)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_init: I.Initializer = None, *, device, dtype,
                 generator):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = I.make_parameter(
            (num_embeddings, embedding_dim), weight_init or I.Normal(0.0, 0.02),
            device=device, dtype=dtype, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return nn.functional.embedding(ids, self.weight)
