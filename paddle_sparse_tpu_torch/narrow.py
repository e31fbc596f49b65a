"""Contiguous range slicing (port of ``paddle_sparse_tpu/narrow.py``).

dim-0 narrows are row pointer arithmetic (no search over nnz); dim-1 narrows
are a column mask. Cache rules as in the reference: ``narrow(0, ...)`` keeps
rowptr/rowcount slices, ``narrow(1, ...)`` keeps colptr/colcount slices,
``__narrow_diag__`` (the inverse of ``cat_diag``) keeps all five cached
fields.
"""
from typing import Tuple

from .storage import SparseStorage
from .tensor import SparseTensor


def narrow(src: SparseTensor, dim: int, start: int, length: int
           ) -> SparseTensor:
    if dim < 0:
        dim = src.dim() + dim
    if start < 0:
        start = src.size(dim) + start

    if dim == 0:
        rowptr, col, value = src.csr()
        rowptr = rowptr[start:start + length + 1]
        row_start = int(rowptr[0])
        rowptr = rowptr - row_start
        row_end = row_start + int(rowptr[-1])

        row = src.storage._row
        if row is not None:
            row = row[row_start:row_end] - start
        col = col[row_start:row_end]
        if value is not None:
            value = value[row_start:row_end]

        rowcount = src.storage._rowcount
        if rowcount is not None:
            rowcount = rowcount[start:start + length]

        storage = SparseStorage(
            row=row, rowptr=rowptr, col=col, value=value,
            sparse_sizes=(length, src.sparse_size(1)), rowcount=rowcount,
            is_sorted=True, trust_data=True)
        return src.from_storage(storage)

    if dim == 1:
        # a col-mask walk over COO is cheaper than building the CSC view
        row, col, value = src.coo()
        mask = (col >= start) & (col < start + length)
        row = row[mask]
        col = col[mask] - start
        if value is not None:
            value = value[mask]

        colptr = src.storage._colptr
        if colptr is not None:
            colptr = colptr[start:start + length + 1]
            colptr = colptr - colptr[0]
        colcount = src.storage._colcount
        if colcount is not None:
            colcount = colcount[start:start + length]

        storage = SparseStorage(
            row=row, col=col, value=value,
            sparse_sizes=(src.sparse_size(0), length),
            colptr=colptr, colcount=colcount,
            is_sorted=True, trust_data=True)
        return src.from_storage(storage)

    value = src.storage.value()
    if value is None:
        raise ValueError("cannot narrow a value dim of a value-less tensor")
    # a slice, not Tensor.narrow: a range past the end is cut, as in JAX
    index = (slice(None),) * (dim - 1) + (slice(start, start + length),)
    return src.set_value(value[index], layout="coo")


def __narrow_diag__(src: SparseTensor, start: Tuple[int, int],
                    length: Tuple[int, int]) -> SparseTensor:
    """Inverse of ``cat_diag``: valid only on diagonally stacked inputs,
    where a row range and a col range address the same nnz range."""
    rowptr, col, value = src.csr()

    rowptr = rowptr[start[0]:start[0] + length[0] + 1]
    row_start = int(rowptr[0])
    rowptr = rowptr - row_start
    row_end = row_start + int(rowptr[-1])

    row = src.storage._row
    if row is not None:
        row = row[row_start:row_end] - start[0]
    col = col[row_start:row_end] - start[1]
    if value is not None:
        value = value[row_start:row_end]

    s = src.storage
    rowcount = s._rowcount
    if rowcount is not None:
        rowcount = rowcount[start[0]:start[0] + length[0]]
    colptr = s._colptr
    if colptr is not None:
        colptr = colptr[start[1]:start[1] + length[1] + 1] - row_start
    colcount = s._colcount
    if colcount is not None:
        colcount = colcount[start[1]:start[1] + length[1]]
    csr2csc = s._csr2csc
    if csr2csc is not None:
        csr2csc = csr2csc[row_start:row_end] - row_start
    csc2csr = s._csc2csr
    if csc2csr is not None:
        csc2csr = csc2csr[row_start:row_end] - row_start

    storage = SparseStorage(
        row=row, rowptr=rowptr, col=col, value=value,
        sparse_sizes=tuple(length), rowcount=rowcount, colptr=colptr,
        colcount=colcount, csr2csc=csr2csc, csc2csr=csc2csr, is_sorted=True,
        trust_data=True)
    return src.from_storage(storage)


SparseTensor.narrow = narrow
SparseTensor.__narrow_diag__ = __narrow_diag__
