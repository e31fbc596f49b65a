"""Sparse * dense-broadcast and sparse * sparse (intersection) multiply
(port of ``paddle_sparse_tpu/mul.py``).

The sparse-sparse intersection concatenates both coalesced COO lists, sorts
them stably by (row, col) and pairs adjacent duplicates; no flat
``row * N + col`` key. The ``*_`` forms rebind the value.
"""
import torch

from .add import _broadcast_to_nnz
from .tensor import SparseTensor
from .utils import lexsort_rowcol


def _times(value, other: torch.Tensor) -> torch.Tensor:
    """``value * other`` in value's dtype; ``other`` where no value."""
    return other if value is None else value * other.to(value.dtype)


def mul(src: SparseTensor, other):
    if not isinstance(other, SparseTensor):
        expanded = _broadcast_to_nnz(src, other)
        return src.set_value(_times(src.storage.value(), expanded),
                             layout="coo")

    if not src.is_coalesced():
        raise ValueError("the `src` tensor is not coalesced")
    if not other.is_coalesced():
        raise ValueError("the `other` tensor is not coalesced")

    rowA, colA, valueA = src.coo()
    rowB, colB, valueB = other.coo()
    if valueA is None or valueB is None:
        raise ValueError("both sparse tensors must contain values")

    row = torch.cat([rowA, rowB])
    col = torch.cat([colA, colB])
    value = torch.cat([valueA, valueB])
    perm = lexsort_rowcol(row, col)
    row, col, value = row[perm], col[perm], value[perm]

    # coalesced inputs: an intersection entry appears exactly twice, and
    # the two occurrences are adjacent after the stable sort
    dup = (row[1:] == row[:-1]) & (col[1:] == col[:-1])
    hit = torch.nonzero(dup).squeeze(1)
    sizes = (max(src.size(0), other.size(0)), max(src.size(1), other.size(1)))
    return SparseTensor(row=row[1:][dup], col=col[1:][dup],
                        value=value[hit] * value[hit + 1],
                        sparse_sizes=sizes)


def mul_(src: SparseTensor, other) -> SparseTensor:
    expanded = _broadcast_to_nnz(src, other)
    return src.set_value_(_times(src.storage.value(), expanded),
                          layout="coo")


def mul_nnz(src: SparseTensor, other, layout=None) -> SparseTensor:
    other = torch.as_tensor(other, device=src.device())
    return src.set_value(_times(src.storage.value(), other), layout=layout)


def mul_nnz_(src: SparseTensor, other, layout=None) -> SparseTensor:
    other = torch.as_tensor(other, device=src.device())
    return src.set_value_(_times(src.storage.value(), other), layout=layout)


SparseTensor.mul = mul
SparseTensor.mul_ = mul_
SparseTensor.mul_nnz = mul_nnz
SparseTensor.mul_nnz_ = mul_nnz_
SparseTensor.__mul__ = mul
SparseTensor.__rmul__ = mul
SparseTensor.__imul__ = mul_
