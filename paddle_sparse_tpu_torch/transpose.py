"""Transposition (port of ``paddle_sparse_tpu/transpose.py``).

``t()`` reuses the csr2csc permutation and swaps every cached field: no
recomputation when the cache is warm. The functional ``transpose`` swaps the
index rows and re-coalesces.
"""
import torch

from .storage import SparseStorage
from .tensor import SparseTensor


def t(src: SparseTensor) -> SparseTensor:
    csr2csc = src.storage.csr2csc()
    row, col, value = src.coo()
    if value is not None:
        value = value[csr2csc]
    M, N = src.storage.sparse_sizes()

    storage = SparseStorage(
        row=col[csr2csc],
        rowptr=src.storage._colptr,
        col=row[csr2csc],
        value=value,
        sparse_sizes=(N, M),
        rowcount=src.storage._colcount,
        colptr=src.storage._rowptr,
        colcount=src.storage._rowcount,
        csr2csc=src.storage._csc2csr,
        csc2csr=csr2csc,
        is_sorted=True, trust_data=True)
    return src.from_storage(storage)


SparseTensor.t = t


def transpose(index, value, m: int, n: int, coalesced: bool = True):
    """Functional tuple-API transpose: swap the two index rows of an
    ``(index, value)`` pair representing an ``m x n`` sparse matrix."""
    row, col = index[1], index[0]
    if coalesced:
        storage = SparseStorage(row=row, col=col, value=value,
                                sparse_sizes=(n, m), is_sorted=False)
        storage = storage.coalesce()
        row, col, value = storage.row(), storage.col(), storage.value()
    return torch.stack([row, col], dim=0), value
