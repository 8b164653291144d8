from . import async_dispatch, fleet
from .async_dispatch import StepResult
from .parallel_layers import (ColumnParallelLinear, RowParallelLinear,
                              VocabParallelEmbedding)
from .recompute import recompute
from .spmd import SpmdTrainer

__all__ = ["async_dispatch", "fleet", "recompute", "ColumnParallelLinear",
           "RowParallelLinear", "VocabParallelEmbedding", "SpmdTrainer",
           "StepResult"]
