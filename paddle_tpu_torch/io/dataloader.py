"""DataLoader (counterpart of ``paddle_tpu/io/dataloader.py``), with
``num_workers=0``.

Batches are collated on the host by ``default_collate_fn`` (numpy
stacks, tensor stacks, dicts and tuples of them) and handed out as
tensors on the loader's device (``places``, default the current device,
``device.set_device``): float64 host data becomes the default float
dtype, as in the JAX package.  Worker processes over the native
shared-memory ring (``io/shm_ring.py``) come with a later slice
(ROADMAP.md Queue 1 item 3.5): ``num_workers > 0`` raises.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..core.dtype import default_float_dtype
from ..device import current_device, resolve_device
from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn", "get_worker_info"]


def default_collate_fn(batch):
    """Stack a list of samples into batch arrays (tensors stay
    tensors)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch, axis=0)
    if torch.is_tensor(sample):
        return torch.stack(batch, dim=0)
    if isinstance(sample, (int, float, np.number)):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn(list(f)) for f in zip(*batch))
    return np.asarray(batch)


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        if num_workers > 0:
            raise NotImplementedError(
                "DataLoader(num_workers > 0) needs the shared-memory worker "
                "ring (io/shm_ring.py), which comes with a later slice "
                "(ROADMAP.md Queue 1 item 3.5); use num_workers=0")
        self.dataset = dataset
        self.places = places
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self._iterable_ds = isinstance(dataset, IterableDataset)
        if self._iterable_ds:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        elif batch_size is None:
            self.batch_sampler = None
            self.batch_size = None
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
            self.batch_size = batch_size

    def __len__(self):
        if self._iterable_ds:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _to_tensors(self, collated, device):
        if isinstance(collated, dict):
            return {k: self._to_tensors(v, device)
                    for k, v in collated.items()}
        if isinstance(collated, (tuple, list)):
            return [self._to_tensors(v, device) for v in collated]
        if isinstance(collated, np.ndarray):
            collated = torch.from_numpy(np.ascontiguousarray(collated))
            if collated.dtype == torch.float64:
                collated = collated.to(default_float_dtype())
        if torch.is_tensor(collated):
            return collated.to(device, non_blocking=True)
        return collated

    def _batches(self):
        """Collated host batches."""
        collate = self.collate_fn
        ds = self.dataset
        if self._iterable_ds:
            it = iter(ds)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch or (len(batch) < self.batch_size
                                 and self.drop_last):
                    return
                yield collate(batch)
        elif self.batch_sampler is None:
            for i in range(len(ds)):
                yield collate([ds[i]])
        else:
            for idxs in self.batch_sampler:
                yield collate([ds[i] for i in idxs])

    def __iter__(self):
        device = current_device() if self.places is None \
            else resolve_device(self.places)
        for collated in self._batches():
            yield self._to_tensors(collated, device)

    def __call__(self):
        return self.__iter__()


def get_worker_info():
    """None: batches are made in the main process."""
    return None
