"""SelectedRows: row-sparse gradients of large embedding tables
(counterpart of ``paddle_tpu/core/selected_rows.py``).

``SelectedRows(rows, values, full_shape)``: ``values[i]`` belongs to row
``rows[i]`` of a ``full_shape`` table; rows may repeat.  A negative row
counts from the end (``-1`` is the last row, as the JAX package's
gathers and scatters read it: ``InMemoryDataset`` pads ragged slots with
``-1``).  ``merge()`` is MergeAdd: each row once, its values summed, in
a result of the input's length whose unused slots hold row
``full_shape[0]`` (out of range) with zero values, so it reads nothing
back to the host: a stable sort, a first-occurrence mask, a cumulative
sum and an index_add.  ``to_dense()`` and ``+ dense`` drop the
out-of-range rows.

``embedding_sparse`` is the lookup whose weight gradient is row-sparse:
its backward returns a sparse COO tensor (``rows`` as its indices, the
output gradient's rows as its values), which PyTorch's autograd
accumulates as the JAX tape does: sparse plus sparse concatenates, and
a dense contribution densifies.  ``SelectedRows.from_sparse`` views such
a ``.grad`` without coalescing it.  Inside ``dense_lookups()`` (the
trainer's step) the lookup is the plain gather.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["SelectedRows", "embedding_sparse", "dense_lookups"]

_tls = threading.local()


@contextlib.contextmanager
def dense_lookups():
    """``embedding(sparse=True)`` inside runs the plain gather, whose
    weight gradient is dense (a compiled or functional step's)."""
    was = getattr(_tls, "dense", False)
    _tls.dense = True
    try:
        yield
    finally:
        _tls.dense = was


def lookups_dense() -> bool:
    return getattr(_tls, "dense", False)


class SelectedRows:
    """Row-sparse tensor: ``values[i]`` is row ``rows[i]`` of the full
    ``full_shape`` tensor (rows may repeat; ``merge()`` dedups)."""

    __slots__ = ("rows", "values", "full_shape")

    def __init__(self, rows, values, full_shape):
        self.full_shape = tuple(int(s) for s in full_shape)
        rows = torch.as_tensor(rows, device=values.device).long().reshape(-1)
        self.rows = torch.where(rows < 0, rows + self.full_shape[0], rows)
        self.values = values
        if values.shape[0] != self.rows.shape[0]:
            raise ValueError(
                f"values rows {values.shape[0]} != ids {self.rows.shape[0]}")
        if tuple(values.shape[1:]) != self.full_shape[1:]:
            raise ValueError(
                f"value row shape {tuple(values.shape[1:])} != dense row "
                f"shape {self.full_shape[1:]}")

    @classmethod
    def from_sparse(cls, t: torch.Tensor) -> "SelectedRows":
        """A view of a sparse COO tensor with one sparse dim (a sparse
        embedding's ``.grad``), uncoalesced."""
        return cls(t._indices()[0], t._values(), t.shape)

    def to_sparse(self) -> torch.Tensor:
        """The sparse COO tensor of the same rows and values."""
        return torch.sparse_coo_tensor(self.rows[None], self.values,
                                       self.full_shape,
                                       check_invariants=False)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def shape(self):
        return self.full_shape

    # ---- conversions ------------------------------------------------------
    def merge(self) -> "SelectedRows":
        """Each row once, its values summed (MergeAdd), ascending; the
        unused tail slots hold row ``full_shape[0]`` and zeros."""
        srt, order = torch.sort(self.rows, stable=True)
        first = torch.ones_like(srt, dtype=torch.bool)
        first[1:] = srt[1:] != srt[:-1]
        seg = torch.cumsum(first, 0) - 1
        uniq = torch.full_like(srt, self.full_shape[0]).scatter_(0, seg, srt)
        summed = self.values.new_zeros(self.values.shape).index_add_(
            0, seg, self.values[order])
        return SelectedRows(uniq, summed, self.full_shape)

    def in_range(self):
        """``(rows, values)`` with the out-of-range rows sent to row 0
        with zero values (an exact no-op when added)."""
        ok = self.rows < self.full_shape[0]
        keep = ok.reshape((-1,) + (1,) * (self.values.dim() - 1))
        return torch.where(ok, self.rows, 0), \
            torch.where(keep, self.values, 0)

    def to_dense(self) -> torch.Tensor:
        dense = self.values.new_zeros(self.full_shape)
        return dense.index_add_(0, *self.in_range())

    def numpy(self):
        return self.to_dense().cpu().numpy()

    # ---- arithmetic (gradient accumulation) -------------------------------
    def __add__(self, other):
        if isinstance(other, SelectedRows):
            if other.full_shape != self.full_shape:
                raise ValueError("SelectedRows shape mismatch: "
                                 f"{self.full_shape} vs {other.full_shape}")
            return SelectedRows(torch.cat([self.rows, other.rows]),
                                torch.cat([self.values, other.values]),
                                self.full_shape)
        rows, vals = self.in_range()
        return other.index_add(0, rows, vals.to(other.dtype))

    __radd__ = __add__

    def __repr__(self):
        return (f"SelectedRows(rows={self.rows.shape[0]}, "
                f"full_shape={self.full_shape}, dtype={self.dtype})")


def gather_rows(ids, weight, padding_idx=None):
    """``weight[ids]`` (negative ids count from the end), zero rows at
    ``padding_idx``: the dense lookup."""
    out = weight[ids]
    if padding_idx is not None:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return out


class _SparseLookup(torch.autograd.Function):
    """Forward: the gather; backward: the weight's gradient as a sparse
    COO tensor, one row an id (zero at ``padding_idx``)."""

    @staticmethod
    def forward(ctx, ids, weight, padding_idx):
        ctx.save_for_backward(ids)
        ctx.full_shape = tuple(weight.shape)
        ctx.padding_idx = padding_idx
        return gather_rows(ids, weight, padding_idx)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        rows = ids.reshape(-1)
        vals = g.reshape((-1,) + ctx.full_shape[1:])
        if ctx.padding_idx is not None:
            vals = torch.where((rows == ctx.padding_idx)[:, None], 0, vals)
        return None, SelectedRows(rows, vals, ctx.full_shape).to_sparse(), \
            None


def embedding_sparse(x, weight, padding_idx=None):
    """Rows of ``weight`` by the ids ``x`` (-1 reads the last row); the
    weight's gradient is row-sparse.  Rows at ``padding_idx`` come out
    zero and pass no gradient."""
    ids = x.long()
    if lookups_dense() or not (torch.is_grad_enabled()
                               and weight.requires_grad):
        return gather_rows(ids, weight, padding_idx)
    return _SparseLookup.apply(ids, weight, padding_idx)
