"""Datasets (counterpart of ``paddle_tpu/io/dataset.py``): map-style and
iterable datasets, compositions, ``random_split``.  Samples are whatever
the dataset returns (numpy arrays, tensors, numbers)."""
from __future__ import annotations

import bisect
import numpy as np

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError(
            "'{}' not implement in class {}".format(
                "__getitem__", self.__class__.__name__))

    def __len__(self):
        raise NotImplementedError(
            "'{}' not implement in class {}".format(
                "__len__", self.__class__.__name__))


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError(
            "'{}' not implement in class {}".format(
                "__iter__", self.__class__.__name__))

    def __getitem__(self, idx):
        raise RuntimeError(
            "'__getitem__' is not supported on IterableDataset")

    def __len__(self):
        raise RuntimeError("'__len__' is not supported on IterableDataset")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors
        lens = {len(t) for t in tensors}
        if len(lens) != 1:
            raise ValueError("all tensors must have the same first dim")

    def __getitem__(self, index):
        return tuple(t[index] for t in self.tensors)

    def __len__(self):
        t = self.tensors[0]
        return t.shape[0] if hasattr(t, "shape") else len(t)


class ComposeDataset(Dataset):
    """Fields of several same-length datasets concatenated per sample."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        lens = {len(d) for d in self.datasets}
        if len(lens) != 1:
            raise ValueError("datasets must share length")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        sample = []
        for d in self.datasets:
            item = d[idx]
            sample.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(sample)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Random disjoint subsets of the given lengths (or fractions);
    the permutation comes from numpy's global generator."""
    n = len(dataset)
    if all(isinstance(l, float) for l in lengths):
        counts = [int(np.floor(n * l)) for l in lengths]
        rem = n - sum(counts)
        for i in range(rem):
            counts[i % len(counts)] += 1
        lengths = counts
    if sum(lengths) != n:
        raise ValueError("sum of lengths != dataset size")
    perm = np.random.permutation(n)
    out, off = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[off:off + l].tolist()))
        off += l
    return out
