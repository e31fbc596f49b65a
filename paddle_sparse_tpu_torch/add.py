"""Sparse + dense-broadcast and sparse + sparse addition
(port of ``paddle_sparse_tpu/add.py``).

Row-vector and col-vector broadcasts gather the dense operand to nnz
positions; sparse + sparse concatenates both COO lists and coalesce-sums.
The ``*_`` forms rebind the value and write into no tensor, so a ``copy()``
of the source keeps its values.
"""
from typing import Optional

import torch

from .ops.segment import gather_csr
from .tensor import SparseTensor


def _broadcast_to_nnz(src: SparseTensor, other) -> torch.Tensor:
    """A (M, 1, ...) or (1, N, ...) dense operand, one entry per nnz."""
    other = torch.as_tensor(other, device=src.device())
    rowptr, col, _ = src.csr()
    if other.shape[0] == src.size(0) and other.shape[1] == 1:  # row-wise
        return gather_csr(other.squeeze(1), rowptr, src.nnz())
    if other.shape[0] == 1 and other.shape[1] == src.size(1):  # col-wise
        return other.squeeze(0)[col]
    raise ValueError(
        f"Size mismatch: expected ({src.size(0)}, 1, ...) or "
        f"(1, {src.size(1)}, ...), got {tuple(other.shape)}.")


def _plus(value: Optional[torch.Tensor], other: torch.Tensor
          ) -> torch.Tensor:
    """``value + other`` in value's dtype; implicit ones where no value."""
    if value is None:
        return other + 1
    return value + other.to(value.dtype)


def add(src: SparseTensor, other):
    if isinstance(other, SparseTensor):
        rowA, colA, valueA = src.coo()
        rowB, colB, valueB = other.coo()
        value: Optional[torch.Tensor] = None
        if valueA is not None and valueB is not None:
            value = torch.cat([valueA, valueB])
        sizes = (max(src.size(0), other.size(0)),
                 max(src.size(1), other.size(1)))
        out = SparseTensor(row=torch.cat([rowA, rowB]),
                           col=torch.cat([colA, colB]), value=value,
                           sparse_sizes=sizes)
        return out.coalesce(reduce="sum")

    if hasattr(other, "shape"):
        expanded = _broadcast_to_nnz(src, other)
        return src.set_value(_plus(src.storage.value(), expanded),
                             layout="coo")

    raise NotImplementedError(f"cannot add {type(other)} to SparseTensor")


def add_(src: SparseTensor, other) -> SparseTensor:
    expanded = _broadcast_to_nnz(src, other)
    return src.set_value_(_plus(src.storage.value(), expanded), layout="coo")


def _plus_nnz(src: SparseTensor, other) -> torch.Tensor:
    value = src.storage.value()
    other = torch.as_tensor(other, device=src.device())
    return other + (1 if value is None else value.to(other.dtype))


def add_nnz(src: SparseTensor, other, layout=None) -> SparseTensor:
    return src.set_value(_plus_nnz(src, other), layout=layout)


def add_nnz_(src: SparseTensor, other, layout=None) -> SparseTensor:
    return src.set_value_(_plus_nnz(src, other), layout=layout)


SparseTensor.add = add
SparseTensor.add_ = add_
SparseTensor.add_nnz = add_nnz
SparseTensor.add_nnz_ = add_nnz_
SparseTensor.__add__ = add
SparseTensor.__radd__ = add
SparseTensor.__iadd__ = add_
