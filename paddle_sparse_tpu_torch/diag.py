"""Diagonal family: remove/set/fill/get diag (port of
``paddle_sparse_tpu/diag.py``; upstream pytorch_sparse semantics: ``k``
selects the diagonal ``col - row == k``, ``set_diag`` inserts an entry at
every diagonal position inside the matrix, ``fill_diag`` is ``set_diag`` with
a constant).

Where the JAX code scatters to a dead index ``M`` with ``mode="drop"``, the
port selects the diagonal entries first and scatters only those: no index
outside the output ever reaches ``index_add_``.
"""
from typing import Optional

import torch

from .storage import SparseStorage
from .tensor import SparseTensor


def remove_diag(src: SparseTensor, k: int = 0) -> SparseTensor:
    row, col, value = src.coo()
    keep = (col - row) != k
    s = src.storage

    rowcount = colcount = None
    if s._rowcount is not None or s._colcount is not None:
        # counts shrink by exactly the removed diagonal positions
        drop = ~keep
        ones = torch.ones_like(row[drop])
        if s._rowcount is not None:
            rowcount = s._rowcount - torch.zeros_like(s._rowcount).index_add_(
                0, row[drop], ones.to(s._rowcount.dtype))
        if s._colcount is not None:
            colcount = s._colcount - torch.zeros_like(s._colcount).index_add_(
                0, col[drop], ones.to(s._colcount.dtype))

    out = SparseStorage(row=row[keep], col=col[keep],
                        value=None if value is None else value[keep],
                        sparse_sizes=src.sparse_sizes(),
                        rowcount=rowcount, colcount=colcount,
                        is_sorted=True, trust_data=True)
    return src.from_storage(out)


def _num_diag(M: int, N: int, k: int) -> int:
    return max(0, min(M, N - k) - max(0, -k))


def set_diag(src: SparseTensor, values: Optional[torch.Tensor] = None,
             k: int = 0) -> SparseTensor:
    src = remove_diag(src, k)
    row, col, value = src.coo()
    M, N = src.sparse_sizes()

    # the diagonal positions that fall inside the matrix
    start = max(0, -k)
    num_diag = _num_diag(M, N, k)
    d = torch.arange(start, start + num_diag, dtype=row.dtype,
                     device=row.device)
    if values is not None:
        values = torch.as_tensor(values, device=row.device)[:num_diag]

    new_value = None
    if value is not None:
        if values is None:
            fill = value.new_ones((num_diag,) + tuple(value.shape[1:]))
        else:
            fill = values.to(value.dtype)
        new_value = torch.cat([value, fill])
    elif values is not None:
        new_value = torch.cat([
            values.new_ones((row.shape[0],) + tuple(values.shape[1:])),
            values])

    return SparseTensor(row=torch.cat([row, d]), col=torch.cat([col, d + k]),
                        value=new_value, sparse_sizes=(M, N), is_sorted=False)


def fill_diag(src: SparseTensor, fill_value: float, k: int = 0
              ) -> SparseTensor:
    """``set_diag`` with ``fill_value`` at every diagonal position, of the
    value's trailing shape (as upstream; the JAX facade raises on trailing
    value dims)."""
    M, N = src.sparse_sizes()
    value = src.storage.value()
    shape = (_num_diag(M, N, k),)
    if value is not None:
        shape += tuple(value.shape[1:])
    dtype = value.dtype if value is not None else torch.float32
    fill = torch.full(shape, fill_value, dtype=dtype, device=src.device())
    return set_diag(src, fill, k)


def get_diag(src: SparseTensor) -> torch.Tensor:
    """Dense main diagonal (zeros where no entry is stored; duplicates
    summed)."""
    row, col, value = src.coo()
    if value is None:
        value = torch.ones((row.shape[0],), dtype=torch.float32,
                           device=row.device)
    on_diag = row == col
    out = value.new_zeros((src.sparse_size(0),) + tuple(value.shape[1:]))
    return out.index_add(0, row[on_diag], value[on_diag])


SparseTensor.remove_diag = remove_diag
SparseTensor.set_diag = set_diag
SparseTensor.fill_diag = fill_diag
SparseTensor.get_diag = get_diag
