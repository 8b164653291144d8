"""Vision datasets (counterpart of ``paddle_tpu/vision/datasets.py``).

``FakeData`` draws exactly what the JAX package's does for the same
``seed`` and ``class_seed`` (numpy ``RandomState``), and ``MNIST`` /
``FashionMNIST`` keep their ``mode='synthetic'`` slice of it.  Reading
dataset files (the MNIST idx files, the Cifar archives,
``DatasetFolder`` / ``ImageFolder``) is not ported: the port's data is
synthetic or in the repo (ROADMAP.md Queue 1 item 3.5), and those
readers raise.
"""
from __future__ import annotations

import numpy as np

from ..io.dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "DatasetFolder",
           "ImageFolder", "FakeData"]


def _no_files(what):
    raise NotImplementedError(
        f"{what} reads dataset files, which the port does not: its data is "
        f"synthetic (FakeData, or MNIST(mode='synthetic')) or in the repo "
        f"(ROADMAP.md Queue 1 item 3.5)")


class FakeData(Dataset):
    """Deterministic synthetic image classification data: per-class
    prototypes from ``class_seed`` plus 0.3 x unit noise drawn from
    ``seed + idx``; labels from ``seed``."""

    def __init__(self, size=1000, image_shape=(1, 28, 28), num_classes=10,
                 transform=None, seed=0, class_seed=1234):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        rng = np.random.RandomState(seed)
        self._labels = rng.randint(0, num_classes, size).astype(np.int64)
        # class prototypes come from class_seed, so splits with another
        # `seed` draw from the same distribution
        self._base = np.random.RandomState(class_seed).randn(
            num_classes, *self.image_shape).astype(np.float32)
        self._seed = seed

    def __getitem__(self, idx):
        lab = self._labels[idx]
        rng = np.random.RandomState(self._seed + idx)
        img = self._base[lab] + 0.3 * rng.randn(*self.image_shape) \
            .astype(np.float32)
        if self.transform is not None:
            img = self.transform(img)
        return img, lab

    def __len__(self):
        return self.size


class MNIST(Dataset):
    """``mode='synthetic'``: 256 ``FakeData`` images of shape (28, 28, 1)
    (the JAX package's slice); any other mode reads files and raises."""

    NAME = "mnist"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode.lower()
        self.transform = transform
        if self.mode != "synthetic":
            _no_files(f"{type(self).__name__}(mode={mode!r})")
        fake = FakeData(size=10000, image_shape=(28, 28, 1))
        self.images = np.stack([fake[i][0] for i in range(256)])
        self.labels = fake._labels[:256]

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.labels)


class FashionMNIST(MNIST):
    NAME = "fashion-mnist"


class Cifar10(Dataset):
    N_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        _no_files(type(self).__name__)


class Cifar100(Cifar10):
    N_CLASSES = 100


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        _no_files(type(self).__name__)


class ImageFolder(DatasetFolder):
    pass
