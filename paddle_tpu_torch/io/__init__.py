"""``paddle.io`` (counterpart of ``paddle_tpu/io``): datasets, samplers,
``DataLoader`` (in this process, on threads, or on fork workers over
shared-memory rings) and the device prefetcher."""
from .dataloader import (DataLoader, WorkerInfo, default_collate_fn,
                         get_worker_info)
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .device_prefetch import DevicePrefetcher
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, WeightedRandomSampler)

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler", "DataLoader", "default_collate_fn",
           "WorkerInfo", "get_worker_info", "DevicePrefetcher"]
