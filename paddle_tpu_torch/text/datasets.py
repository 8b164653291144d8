"""Text datasets (counterpart of ``paddle_tpu/text/datasets.py``):
``UCIHousing``, ``Imdb``, ``Imikolov``, ``Movielens``, ``WMT14``,
``WMT16``, ``Conll05st``.

Paddle downloads these archives when a dataset is built; this package
never downloads.  Each dataset reads a local ``data_file`` in the
on-disk format Paddle expects where the JAX package has a reader
(``UCIHousing``, ``Imdb``, ``Imikolov``), or with ``mode='synthetic'``
(or no file) generates an in-memory sample set of the right shapes from
the JAX package's ``np.random.RandomState`` seeds, so the arrays equal
its arrays bit for bit.  Where the JAX package raises (``Movielens``,
``WMT14`` and ``WMT16`` from a file), so does the port, with the same
error class.  As in the JAX package, ``WMT16`` draws its target ids
from ``src_dict_size`` and leaves ``trg_dict_size`` unused.

Items are numpy arrays, as the JAX package's are; a ``DataLoader``
turns them into tensors.
"""
from __future__ import annotations

import gzip
import os
import re
import tarfile
from typing import List, Optional

import numpy as np

from ..io.dataset import Dataset

__all__ = ["UCIHousing", "Imdb", "Imikolov", "Movielens", "WMT14",
           "WMT16", "Conll05st"]


def _need_file(data_file, name):
    if data_file is None:
        raise ValueError(
            f"{name}: pass data_file=<local path> (no network downloads "
            f"in this runtime) or mode='synthetic' for generated data")
    if not os.path.exists(data_file):
        raise FileNotFoundError(f"{name}: data_file {data_file} not found")
    return data_file


class UCIHousing(Dataset):
    """Boston housing regression: 13 features -> price, each feature
    column normalized by its mean and range over the whole file, then
    split 80 / 20 into train / test."""

    FEATURE_DIM = 13

    def __init__(self, data_file=None, mode="train"):
        self.mode = mode.lower()
        if self.mode == "synthetic" or data_file is None:
            rng = np.random.RandomState(42)
            n = 404 if self.mode != "test" else 102
            self.data = rng.randn(n, self.FEATURE_DIM).astype(np.float32)
            w = rng.randn(self.FEATURE_DIM).astype(np.float32)
            self.label = (self.data @ w + 0.1 * rng.randn(n)).astype(
                np.float32)[:, None]
            return
        path = _need_file(data_file, "UCIHousing")
        raw = np.fromfile(path, sep=" ", dtype=np.float32)
        raw = raw.reshape(-1, self.FEATURE_DIM + 1)
        maximums = raw.max(axis=0)
        minimums = raw.min(axis=0)
        avgs = raw.sum(axis=0) / raw.shape[0]
        for i in range(self.FEATURE_DIM):
            raw[:, i] = (raw[:, i] - avgs[i]) / (maximums[i] - minimums[i])
        split = int(raw.shape[0] * 0.8)
        part = raw[:split] if self.mode == "train" else raw[split:]
        self.data = part[:, :-1]
        self.label = part[:, -1:]

    def __getitem__(self, idx):
        return self.data[idx], self.label[idx]

    def __len__(self):
        return len(self.data)


class Imdb(Dataset):
    """IMDB sentiment: tokenized reviews -> 0 / 1 (``aclImdb`` tar: words
    above ``cutoff`` occurrences get ids from 2 by frequency, 1 is
    unknown; reviews padded or cut to ``seq_len``)."""

    def __init__(self, data_file=None, mode="train", cutoff=150,
                 seq_len=64, vocab_size=5000):
        self.mode = mode.lower()
        self.seq_len = seq_len
        if self.mode == "synthetic" or data_file is None:
            rng = np.random.RandomState(7)
            n = 256
            self.docs = rng.randint(2, vocab_size, (n, seq_len)).astype(
                np.int64)
            self.labels = rng.randint(0, 2, (n,)).astype(np.int64)
            self.word_idx = {f"w{i}": i for i in range(vocab_size)}
            return
        path = _need_file(data_file, "Imdb")
        pat = re.compile(
            rf"aclImdb/{'train' if self.mode == 'train' else 'test'}"
            rf"/(pos|neg)/.*\.txt$")
        docs, labels = [], []
        freq = {}
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                if pat.match(m.name):
                    toks = tf.extractfile(m).read().decode(
                        "latin-1").lower().split()
                    docs.append(toks)
                    labels.append(0 if "/neg/" in m.name else 1)
                    for t in toks:
                        freq[t] = freq.get(t, 0) + 1
        words = [w for w, c in sorted(freq.items(),
                                      key=lambda kv: (-kv[1], kv[0]))
                 if c > cutoff]
        self.word_idx = {w: i + 2 for i, w in enumerate(words)}
        from .utils import pad_sequences
        ids = [[self.word_idx.get(t, 1) for t in d] for d in docs]
        self.docs = pad_sequences(ids, maxlen=seq_len)
        self.labels = np.asarray(labels, np.int64)

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """PTB n-gram language model data (``simple-examples`` tar): sliding
    ``window_size``-grams over ``<s> line <e>``, words of at least
    ``min_word_freq`` occurrences by frequency, then ``<unk>``."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50, vocab_size=2000):
        self.window = window_size
        if mode.lower() == "synthetic" or data_file is None:
            rng = np.random.RandomState(11)
            stream = rng.randint(2, vocab_size, (20000,)).astype(np.int64)
            self.samples = np.lib.stride_tricks.sliding_window_view(
                stream, window_size).copy()
            self.word_idx = {f"w{i}": i for i in range(vocab_size)}
            return
        path = _need_file(data_file, "Imikolov")
        fname = f"./simple-examples/data/ptb.{mode}.txt"
        freq = {}
        lines = []
        with tarfile.open(path) as tf:
            for line in tf.extractfile(fname).read().decode().split("\n"):
                toks = ["<s>"] + line.strip().split() + ["<e>"]
                lines.append(toks)
                for t in toks:
                    freq[t] = freq.get(t, 0) + 1
        words = [w for w, c in freq.items() if c >= min_word_freq and
                 w != "<unk>"]
        words.sort(key=lambda w: (-freq[w], w))
        self.word_idx = {w: i for i, w in enumerate(words)}
        unk = len(self.word_idx)
        self.word_idx["<unk>"] = unk
        samples = []
        for toks in lines:
            ids = [self.word_idx.get(t, unk) for t in toks]
            for i in range(len(ids) - window_size + 1):
                samples.append(ids[i:i + window_size])
        self.samples = np.asarray(samples, np.int64)

    def __getitem__(self, idx):
        row = self.samples[idx]
        return row[:-1], row[-1:]

    def __len__(self):
        return len(self.samples)


class Movielens(Dataset):
    """MovieLens-1M rating prediction (synthetic rows only)."""

    def __init__(self, data_file=None, mode="train"):
        if mode.lower() == "synthetic" or data_file is None:
            rng = np.random.RandomState(5)
            n = 512
            self.rows = [
                (rng.randint(1, 6041), rng.randint(0, 2), rng.randint(1, 57),
                 rng.randint(0, 21), rng.randint(1, 3953),
                 rng.randint(0, 19, size=(3,)).astype(np.int64),
                 np.float32(rng.randint(1, 6)))
                for _ in range(n)]
            return
        raise NotImplementedError(
            "Movielens from archive: supply mode='synthetic' or implement "
            "loading from a local ml-1m archive")

    def __getitem__(self, idx):
        u, gender, age, job, mov, cats, rating = self.rows[idx]
        return (np.int64(u), np.int64(gender), np.int64(age),
                np.int64(job), np.int64(mov), cats, rating)

    def __len__(self):
        return len(self.rows)


class _ParallelCorpus(Dataset):
    """Shared shape for WMT14/WMT16: (src_ids, trg_ids, trg_next)."""

    def __init__(self, mode, seq_len, vocab_size, seed):
        rng = np.random.RandomState(seed)
        n = 256
        self.src = rng.randint(3, vocab_size, (n, seq_len)).astype(np.int64)
        self.trg = rng.randint(3, vocab_size, (n, seq_len)).astype(np.int64)
        self.trg[:, 0] = 0  # <s>
        self.trg_next = np.roll(self.trg, -1, axis=1)
        self.trg_next[:, -1] = 1  # <e>

    def __getitem__(self, idx):
        return self.src[idx], self.trg[idx], self.trg_next[idx]

    def __len__(self):
        return len(self.src)


class WMT14(_ParallelCorpus):
    """WMT14 (synthetic pairs only)."""

    def __init__(self, data_file=None, mode="train", dict_size=30000,
                 seq_len=32):
        if data_file is not None:
            raise NotImplementedError(
                "WMT14 archive loading needs network-fetched dicts; use "
                "mode='synthetic'")
        super().__init__(mode, seq_len, min(dict_size, 30000), seed=14)


class WMT16(_ParallelCorpus):
    """WMT16 (synthetic pairs only); target ids come from
    ``src_dict_size`` too, as in the JAX package."""

    def __init__(self, data_file=None, mode="train", src_dict_size=30000,
                 trg_dict_size=30000, seq_len=32):
        if data_file is not None:
            raise NotImplementedError(
                "WMT16 archive loading: use mode='synthetic'")
        super().__init__(mode, seq_len, min(src_dict_size, 30000), seed=16)


class Conll05st(Dataset):
    """Semantic role labelling (synthetic only): the 9-column tuple
    layout."""

    def __init__(self, data_file=None, mode="train", seq_len=32,
                 word_dict_size=5000, label_dict_size=59):
        rng = np.random.RandomState(55)
        n = 128
        self.cols = [
            tuple(rng.randint(0, word_dict_size, (seq_len,)).astype(np.int64)
                  for _ in range(8)) +
            (rng.randint(0, label_dict_size, (seq_len,)).astype(np.int64),)
            for _ in range(n)]

    def __getitem__(self, idx):
        return self.cols[idx]

    def __len__(self):
        return len(self.cols)
