"""Single-device forms of the tensor-parallel layers (counterpart of
``paddle_tpu/distributed/parallel_layers.py``).

Weights keep the JAX layout ``[in_features, out_features]`` (so
``y = x @ W + b``) and the JAX parameter names, which lets
``models.convert`` move weights between the packages without a
transpose.  Sharding over a tensor-parallel axis comes with the
multi-device slice.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn import initializer as I

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]


class _Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 weight_init: I.Initializer = None, has_bias: bool = True, *,
                 device, dtype, generator):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = I.make_parameter(
            (in_features, out_features), weight_init or I.XavierUniform(),
            device=device, dtype=dtype, generator=generator)
        self.bias = I.make_parameter((out_features,), 0.0, device=device,
                                     dtype=dtype, generator=None) \
            if has_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
