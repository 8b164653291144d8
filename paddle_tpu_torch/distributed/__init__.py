from . import async_dispatch, checkpoint, fleet
from .async_dispatch import StepResult
from .checkpoint import latest_checkpoint
from .parallel_layers import (ColumnParallelLinear, RowParallelLinear,
                              VocabParallelEmbedding)
from .recompute import recompute
from .resilience import CheckpointManager, PreemptionGuard
from .spmd import SpmdTrainer

__all__ = ["async_dispatch", "checkpoint", "fleet", "recompute",
           "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "SpmdTrainer", "StepResult",
           "PreemptionGuard", "CheckpointManager", "latest_checkpoint"]
