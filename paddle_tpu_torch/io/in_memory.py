"""InMemoryDataset: the slot-based CTR dataset with in-memory shuffles
(counterpart of ``paddle_tpu/io/in_memory.py``, host code kept as it is
there).

Records are slot records, from the SlotRecord text format ("label
slot:feasign slot:feasign ...", ``load_into_memory``) or from Python
(``set_records``); they parse into dicts, the shuffles are in-memory
permutations, and batches come out as numpy arrays: a sparse id slot as
ids ``[B, max_ids]`` int64 padded with -1 plus ``'<slot>@len'`` lengths
(``Embedding(sparse=True)`` reads -1 as the table's last row: mask the
padding out of what it feeds), a dense slot as ``[B, dim]`` float32,
the labels as ``[B, n_labels]`` float32.  Move them to the card with
``to_tensor``.
"""
from __future__ import annotations

import hashlib
import random
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["InMemoryDataset"]


class InMemoryDataset:
    def __init__(self, use_slots: Optional[Sequence[str]] = None,
                 dense_slots: Optional[Dict[str, int]] = None,
                 batch_size: int = 1, label_slot: str = "label"):
        """use_slots: sparse id slots to keep (None = keep all seen);
        dense_slots: name -> dim for float slots; label_slot: name under
        which leading label values are stored."""
        self.use_slots = list(use_slots) if use_slots else None
        self.dense_slots = dict(dense_slots or {})
        self.batch_size = int(batch_size)
        self.label_slot = label_slot
        self._records: List[dict] = []

    # ---- configuration (fluid.dataset API names) -----------------------
    def set_batch_size(self, batch_size: int):
        self.batch_size = int(batch_size)

    def set_use_var(self, slots: Sequence[str]):
        self.use_slots = list(slots)

    # ---- loading -------------------------------------------------------
    def parse_line(self, line: str) -> Optional[dict]:
        """SlotRecord text: 'label [label2 ...] slot:val slot:val ...'.
        Leading bare numbers are labels; 'name:value' pairs fill slots
        (sparse slots collect int ids, dense slots collect floats)."""
        parts = line.split()
        if not parts:
            return None
        rec: dict = {self.label_slot: []}
        for p in parts:
            if ":" not in p:
                rec[self.label_slot].append(float(p))
                continue
            name, val = p.split(":", 1)
            if name in self.dense_slots:
                rec.setdefault(name, []).append(float(val))
            elif self.use_slots is None or name in self.use_slots:
                rec.setdefault(name, []).append(int(val))
        return rec

    def load_into_memory(self, filelist: Sequence[str]):
        """Read every line of every file into memory (the reference's
        LoadIntoMemory over its file queue)."""
        for path in filelist:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = self.parse_line(line)
                    if rec is not None:
                        self._records.append(rec)

    def set_records(self, records: Sequence[dict]):
        """Programmatic load (tests / in-process producers)."""
        self._records = list(records)

    # ---- shuffle -------------------------------------------------------
    def local_shuffle(self, seed: Optional[int] = None):
        random.Random(seed).shuffle(self._records)

    def global_shuffle(self, rank: int = 0, world: int = 1,
                       seed: Optional[int] = None):
        """Deterministic cross-trainer repartition + shuffle (reference
        GlobalShuffle): every trainer must hold the SAME loaded record
        set (load the full filelist everywhere); each keeps the records
        hashing to its rank, then shuffles locally.  The union across
        ranks is exactly the original set, with a shuffle that does not
        depend on the original per-rank partition."""
        if world > 1:
            def key(i, rec):
                h = hashlib.md5(
                    f"{seed or 0}:{i}:{sorted(rec.items())!r}"
                    .encode()).digest()
                return int.from_bytes(h[:8], "big")
            self._records = [r for i, r in enumerate(self._records)
                             if key(i, r) % world == rank]
        self.local_shuffle(seed)

    def release_memory(self):
        self._records = []

    def get_memory_data_size(self) -> int:
        return len(self._records)

    # ---- batching ------------------------------------------------------
    def _slot_names(self) -> List[str]:
        names = set()
        for r in self._records:
            names.update(r.keys())
        names.discard(self.label_slot)
        return sorted(names)

    def batch_generator(self, batch_size: Optional[int] = None,
                        drop_last: bool = False
                        ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield {slot: array} batches: sparse slots -> (ids [B, T] int64
        padded with -1, '<slot>@len' [B] int64); dense slots -> [B, dim]
        float32; labels -> [B, n_labels] float32."""
        bs = batch_size or self.batch_size
        names = self._slot_names()
        for lo in range(0, len(self._records), bs):
            chunk = self._records[lo:lo + bs]
            if drop_last and len(chunk) < bs:
                return
            out: Dict[str, np.ndarray] = {}
            labels = [r.get(self.label_slot, []) for r in chunk]
            width = max((len(l) for l in labels), default=0)
            lab = np.zeros((len(chunk), max(width, 1)), np.float32)
            for i, l in enumerate(labels):
                lab[i, :len(l)] = l
            out[self.label_slot] = lab
            for name in names:
                if name in self.dense_slots:
                    dim = self.dense_slots[name]
                    arr = np.zeros((len(chunk), dim), np.float32)
                    for i, r in enumerate(chunk):
                        v = r.get(name, [])
                        arr[i, :len(v)] = v
                    out[name] = arr
                else:
                    rows = [r.get(name, []) for r in chunk]
                    t = max((len(x) for x in rows), default=0)
                    ids = np.full((len(chunk), max(t, 1)), -1, np.int64)
                    lens = np.zeros((len(chunk),), np.int64)
                    for i, x in enumerate(rows):
                        ids[i, :len(x)] = x
                        lens[i] = len(x)
                    out[name] = ids
                    out[f"{name}@len"] = lens
            yield out

    def __iter__(self):
        return self.batch_generator()
