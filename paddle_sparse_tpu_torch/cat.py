"""Concatenation along rows, cols, the diagonal, or value dims
(port of ``paddle_sparse_tpu/cat.py``).

Cache rules as in the reference: dim-0 keeps row/rowptr/rowcount, dim-1
keeps colptr/colcount (the output needs re-sorting), the diagonal keeps all
five cached fields.
"""
from typing import List

import torch

from .storage import SparseStorage
from .tensor import SparseTensor


def _maybe_cat(parts, n_tensors: int, dim: int = 0):
    return torch.cat(parts, dim=dim) if len(parts) == n_tensors else None


def cat(tensors: List[SparseTensor], dim) -> SparseTensor:
    if len(tensors) == 0:
        raise ValueError("cat needs at least one tensor")

    if isinstance(dim, (tuple, list)):
        if sorted(dim) != [0, 1]:
            raise ValueError(f"a diagonal cat takes dim (0, 1), got {dim}")
        return cat_diag(tensors)

    dim = tensors[0].dim() + dim if dim < 0 else dim
    if dim == 0:
        return cat_first(tensors)
    if dim == 1:
        return cat_second(tensors)
    if 1 < dim < tensors[0].dim():
        values = []
        for tensor in tensors:
            value = tensor.storage.value()
            if value is None:
                raise ValueError("cat along a value dim needs values")
            values.append(value)
        return tensors[0].set_value(torch.cat(values, dim=dim - 1),
                                    layout="coo")
    raise IndexError(
        f"dimension out of range: expected within "
        f"[{-tensors[0].dim()}, {tensors[0].dim() - 1}], got {dim}")


def cat_first(tensors: List[SparseTensor]) -> SparseTensor:
    n = len(tensors)
    rows, rowptrs, cols, values, rowcounts = [], [], [], [], []
    M, N, nnz = 0, 0, 0
    for tensor in tensors:
        s = tensor.storage
        if s._row is not None:
            rows.append(s._row + M)
        if s._rowptr is not None:
            rowptrs.append(s._rowptr[1:] + nnz if rowptrs else s._rowptr)
        cols.append(s._col)
        if s._value is not None:
            values.append(s._value)
        if s._rowcount is not None:
            rowcounts.append(s._rowcount)
        M += tensor.sparse_size(0)
        N = max(N, tensor.sparse_size(1))
        nnz += tensor.nnz()

    storage = SparseStorage(
        row=_maybe_cat(rows, n), rowptr=_maybe_cat(rowptrs, n),
        col=torch.cat(cols), value=_maybe_cat(values, n),
        sparse_sizes=(M, N), rowcount=_maybe_cat(rowcounts, n),
        is_sorted=True)
    return tensors[0].from_storage(storage)


def cat_second(tensors: List[SparseTensor]) -> SparseTensor:
    n = len(tensors)
    rows, cols, values, colptrs, colcounts = [], [], [], [], []
    M, N, nnz = 0, 0, 0
    for tensor in tensors:
        row, _, value = tensor.coo()
        s = tensor.storage
        rows.append(row)
        cols.append(s._col + N)
        if value is not None:
            values.append(value)
        if s._colptr is not None:
            colptrs.append(s._colptr[1:] + nnz if colptrs else s._colptr)
        if s._colcount is not None:
            colcounts.append(s._colcount)
        M = max(M, tensor.sparse_size(0))
        N += tensor.sparse_size(1)
        nnz += tensor.nnz()

    # rows interleave across inputs: the constructor re-sorts; counts and
    # pointers stay valid, permutation caches are rebuilt lazily.
    storage = SparseStorage(
        row=torch.cat(rows), col=torch.cat(cols),
        value=_maybe_cat(values, n), sparse_sizes=(M, N),
        colptr=_maybe_cat(colptrs, n),
        colcount=_maybe_cat(colcounts, n), is_sorted=False)
    return tensors[0].from_storage(storage)


def cat_diag(tensors: List[SparseTensor]) -> SparseTensor:
    n = len(tensors)
    rows, rowptrs, cols, values = [], [], [], []
    rowcounts, colptrs, colcounts, csr2cscs, csc2csrs = [], [], [], [], []
    M, N, nnz = 0, 0, 0
    for tensor in tensors:
        s = tensor.storage
        if s._row is not None:
            rows.append(s._row + M)
        if s._rowptr is not None:
            rowptrs.append(s._rowptr[1:] + nnz if rowptrs else s._rowptr)
        cols.append(s._col + N)
        if s._value is not None:
            values.append(s._value)
        if s._rowcount is not None:
            rowcounts.append(s._rowcount)
        if s._colptr is not None:
            colptrs.append(s._colptr[1:] + nnz if colptrs else s._colptr)
        if s._colcount is not None:
            colcounts.append(s._colcount)
        if s._csr2csc is not None:
            csr2cscs.append(s._csr2csc + nnz)
        if s._csc2csr is not None:
            csc2csrs.append(s._csc2csr + nnz)
        M += tensor.sparse_size(0)
        N += tensor.sparse_size(1)
        nnz += tensor.nnz()

    storage = SparseStorage(
        row=_maybe_cat(rows, n), rowptr=_maybe_cat(rowptrs, n),
        col=torch.cat(cols), value=_maybe_cat(values, n),
        sparse_sizes=(M, N), rowcount=_maybe_cat(rowcounts, n),
        colptr=_maybe_cat(colptrs, n),
        colcount=_maybe_cat(colcounts, n),
        csr2csc=_maybe_cat(csr2cscs, n),
        csc2csr=_maybe_cat(csc2csrs, n), is_sorted=True)
    return tensors[0].from_storage(storage)
