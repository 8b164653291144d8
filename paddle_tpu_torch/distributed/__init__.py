from . import async_dispatch, checkpoint, fleet, moe
from .async_dispatch import StepResult
from .checkpoint import latest_checkpoint
from .moe import (ExpertParallelFFN, MoELayer, add_aux_loss,
                  collect_aux_losses)
from .parallel_layers import (ColumnParallelLinear, RowParallelLinear,
                              VocabParallelEmbedding)
from .recompute import recompute
from .resilience import CheckpointManager, PreemptionGuard
from .spmd import SpmdTrainer

__all__ = ["async_dispatch", "checkpoint", "fleet", "moe", "recompute",
           "MoELayer", "ExpertParallelFFN", "collect_aux_losses",
           "add_aux_loss",
           "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "SpmdTrainer", "StepResult",
           "PreemptionGuard", "CheckpointManager", "latest_checkpoint"]
